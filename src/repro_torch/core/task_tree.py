"""Explicit task tree with caterpillar topology (paper §3.4, Algorithms 5-6).

A copy of ``repro/core/task_tree.py`` (pure Python).  Nodes are keyed by
``id(payload)``: payloads stay the host objects the caller registered.

Each exploration thread owns a :class:`TaskTree`.  The root is the task the
thread was given; children are registered by ``register_child_instances``
before the thread explores them (``search`` claims a child for sequential
exploration, removing it on completion).  At any time the *highest-priority*
(shallowest, leftmost) pending task can be extracted for donation with
``send_highest_priority_task`` (Alg. 6: re-root past single-child nodes, then
take the leftmost non-exploring leaf-child).

Invariant (paper §3.4 "Size of task trees"): the tree is always a caterpillar
— every internal node has at most one internal child, since only the node
currently being explored sequentially can grow children.  Hence memory is
O(max_b · D).  ``check_caterpillar`` asserts this and is exercised by tests
and (optionally) by the simulator after every operation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(eq=False)  # identity semantics: payloads may be arrays
class _Node:
    payload: Any
    depth: int
    exploring: bool = False
    children: list["_Node"] = dataclasses.field(default_factory=list)
    parent: Optional["_Node"] = None


class TaskTree:
    """Alg. 5/6 task tree for one exploration thread."""

    def __init__(self):
        self.root: Optional[_Node] = None
        self._index: dict[int, _Node] = {}  # id(payload-key) -> node

    # -- bookkeeping ------------------------------------------------------
    def __len__(self) -> int:
        def count(node):
            return 1 + sum(count(c) for c in node.children) if node else 0

        return count(self.root)

    def is_empty(self) -> bool:
        return self.root is None

    def _key(self, payload: Any) -> int:
        return id(payload)

    # -- Alg. 5: registerChildInstances ------------------------------------
    def set_root(self, payload: Any, depth: int = 0) -> None:
        assert self.root is None, "root already set"
        self.root = _Node(payload=payload, depth=depth, exploring=True)
        self._index[self._key(payload)] = self.root

    def register_child_instances(self, children: list[Any], parent: Any) -> None:
        """Add each child under ``parent`` in the task tree (Alg. 5 lines 1-5).

        In practice the parent is the node currently being explored by this
        thread; children are appended in heuristic order (leftmost = most
        promising, §3.4)."""
        pnode = self._index.get(self._key(parent))
        if pnode is None:
            # parent already finished/donated: children are explored by the
            # caller directly and are not tracked (cannot be donated).
            return
        for child in children:
            cnode = _Node(payload=child, depth=pnode.depth + 1, parent=pnode)
            pnode.children.append(cnode)
            self._index[self._key(child)] = cnode

    # -- Alg. 5: search ----------------------------------------------------
    def try_claim(self, payload: Any) -> bool:
        """If ``payload`` is still in the tree, mark it Exploring and return
        True (the caller then explores it sequentially); else return False
        (it was donated to another thread/process)."""
        node = self._index.get(self._key(payload))
        if node is None:
            return False
        node.exploring = True
        return True

    def finish(self, payload: Any) -> None:
        """Remove a fully-explored task (Alg. 5 line 10)."""
        node = self._index.pop(self._key(payload), None)
        if node is None:
            return
        assert not node.children, "finishing a task with pending children"
        if node.parent is not None:
            node.parent.children.remove(node)
        if node is self.root:
            self.root = None

    # -- Alg. 6: sendHighestPriorityTask ------------------------------------
    def pop_highest_priority(self) -> Optional[Any]:
        """Extract the shallowest, leftmost pending task; None if no pending
        task exists.  Implements the re-rooting walk of Alg. 6."""
        r = self.root
        while True:
            if r is None:
                return None
            if not r.children:
                # only the exploring path remains
                return None
            if len(r.children) == 1 and (
                r.children[0].exploring or r.children[0].children
            ):
                # single child on the exploration path: re-root (Alg. 6 line 8)
                old = r
                r = r.children[0]
                self._index.pop(self._key(old.payload), None)
                r.parent = None
                self.root = r
                continue
            # leftmost leaf-child not marked Exploring
            cand = None
            for c in r.children:
                if not c.exploring and not c.children:
                    cand = c
                    break
            if cand is None:
                # all children exploring / internal: descend the exploration path
                nxt = next((c for c in r.children if c.exploring or c.children), None)
                if nxt is None:
                    return None
                r = nxt
                continue
            r.children.remove(cand)
            self._index.pop(self._key(cand.payload), None)
            return cand.payload

    def pending_count(self) -> int:
        """Number of tasks that could be donated (non-exploring leaves)."""
        cnt = 0

        def walk(node):
            nonlocal cnt
            if node is None:
                return
            for c in node.children:
                if not c.exploring and not c.children:
                    cnt += 1
                walk(c)

        walk(self.root)
        return cnt

    def top_priority_depth(self) -> Optional[int]:
        """Depth of the task pop_highest_priority would return (metadata int)."""
        best = None

        def walk(node):
            nonlocal best
            if node is None:
                return
            for c in node.children:
                if not c.exploring and not c.children:
                    if best is None or c.depth < best:
                        best = c.depth
                walk(c)

        walk(self.root)
        return best

    # -- invariant ----------------------------------------------------------
    def check_caterpillar(self) -> bool:
        """Every node has at most one non-leaf child (paper §3.4)."""

        def walk(node) -> bool:
            if node is None:
                return True
            internal_children = [c for c in node.children if c.children]
            if len(internal_children) > 1:
                return False
            return all(walk(c) for c in node.children)

        return walk(self.root)
