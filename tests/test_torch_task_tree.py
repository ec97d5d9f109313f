"""The port's caterpillar task tree (Algorithms 5-6) against the JAX package's.

``repro_torch.core.task_tree`` is its own copy of ``repro/core/task_tree.py``.
Here test_task_tree.py's cases run on the port, and the caterpillar random
walk runs on both trees with the same seeded operations: every donation
returns the same payload, and the pending count, the top-priority depth,
the size and the caterpillar invariant agree after every operation.
"""

import random

from repro.core.task_tree import TaskTree as JaxTaskTree
from repro_torch.core.task_tree import TaskTree
from tests._hypothesis_compat import given, settings, strategies as st


class T:
    """Identity-keyed payload."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"T({self.name})"


def test_register_and_claim():
    tree = TaskTree()
    root = T("root")
    tree.set_root(root)
    kids = [T("a"), T("b")]
    tree.register_child_instances(kids, root)
    assert tree.pending_count() == 2
    assert tree.try_claim(kids[0])
    assert tree.pending_count() == 1
    assert tree.check_caterpillar()


def test_donation_is_shallowest_leftmost():
    tree = TaskTree()
    root = T("root")
    tree.set_root(root)
    a, b = T("a"), T("b")
    tree.register_child_instances([a, b], root)
    tree.try_claim(a)
    a1, a2 = T("a1"), T("a2")
    tree.register_child_instances([a1, a2], a)
    assert tree.pop_highest_priority() is b
    assert tree.pop_highest_priority() is a1


def test_rerooting_past_single_child():
    tree = TaskTree()
    root = T("root")
    tree.set_root(root)
    a = T("a")
    tree.register_child_instances([a], root)
    tree.try_claim(a)
    a1, a2 = T("a1"), T("a2")
    tree.register_child_instances([a1, a2], a)
    assert tree.pop_highest_priority() is a1
    assert tree.root.payload is a


def test_finish_removes_and_empties():
    tree = TaskTree()
    root = T("root")
    tree.set_root(root)
    a, b = T("a"), T("b")
    tree.register_child_instances([a, b], root)
    tree.try_claim(a)
    tree.finish(a)
    assert tree.pop_highest_priority() is b
    tree.finish(root)
    assert tree.is_empty()


def test_register_after_donation_is_ignored():
    tree = TaskTree()
    root = T("root")
    tree.set_root(root)
    a, b = T("a"), T("b")
    tree.register_child_instances([a, b], root)
    assert tree.pop_highest_priority() is a
    tree.register_child_instances([T("a1")], a)  # parent gone: no-op
    assert tree.pending_count() == 1


def _walk_step(tree, stack, op, rng, made):
    """One operation of the caterpillar walk on one tree; returns what a
    donation gave (its name) and the new payload count."""
    cur = stack[-1]
    got = None
    if op in ("branch2", "branch3") and len(stack) < 12:
        k = 2 if op == "branch2" else 3
        kids = [T(f"n{made + i}") for i in range(k)]
        made += k
        tree.register_child_instances(kids, cur)
        child = kids[rng.randrange(k)]
        if tree.try_claim(child):
            stack.append(child)
    elif op == "donate":
        before = tree.pending_count()
        payload = tree.pop_highest_priority()
        assert (payload is None) == (before == 0)
        if payload is not None:
            assert tree.pending_count() == before - 1
            got = payload.name
    elif op == "up" and len(stack) > 1:
        done = stack.pop()
        node = tree._index.get(id(done))
        if node is not None:
            while node.children:
                c = node.children[0]
                node.children.remove(c)
                tree._index.pop(id(c.payload), None)
            tree.finish(done)
    return got, made


def _view(tree) -> tuple:
    return (tree.pending_count(), tree.top_priority_depth(), len(tree),
            tree.is_empty(), tree.check_caterpillar())


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(["branch2", "branch3", "donate", "up"]),
                min_size=1, max_size=120), st.integers(0, 2**31))
def test_caterpillar_walk_equals_jax(ops, seed):
    """Simulated DFS with random donations on both trees: the caterpillar
    topology holds, and every donation and view agrees with JAX's tree."""
    rng_ours, rng_theirs = random.Random(seed), random.Random(seed)
    ours, theirs = TaskTree(), JaxTaskTree()
    r1, r2 = T("root"), T("root")
    ours.set_root(r1)
    theirs.set_root(r2)
    s1, s2 = [r1], [r2]
    m1 = m2 = 0
    for op in ops:
        got, m1 = _walk_step(ours, s1, op, rng_ours, m1)
        want, m2 = _walk_step(theirs, s2, op, rng_theirs, m2)
        assert got == want, op
        assert [t.name for t in s1] == [t.name for t in s2]
        assert _view(ours) == _view(theirs)
        assert ours.check_caterpillar()
