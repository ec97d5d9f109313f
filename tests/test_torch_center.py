"""The port's Algorithm-3 center against the JAX package's.

``repro_torch.core.center`` is its own copy of ``repro/core/center.py``.
Here test_center.py's cases run on the port, and both centers take the same
seeded streams of messages and must answer alike at every step: the donor
each ``available`` gets (the ``random`` policy draws from
``random.Random(seed)`` in the same order), the pair each
``started_running`` feeds, each best-value verdict, and the whole state
(status, best, holder, metadata, the assignment chain) after each message.
"""

import random

import pytest

from repro.core import center as jax_center
from repro_torch.core.center import CenterState, Status


def test_offer_best_verifies():
    c = CenterState(num_workers=3)
    assert c.offer_best(1, 10)
    assert not c.offer_best(2, 12)
    assert c.offer_best(2, 7)
    assert c.best_holder == 2


def test_available_assignment_pins():
    c = CenterState(num_workers=3, seed=1)
    w = c.on_available(2)
    assert w in (1, 3)
    assert c.status[2] == Status.ASSIGNED
    assert c.assigned_to[2] == w


def test_no_donor_stays_available():
    c = CenterState(num_workers=2)
    c.status[1] = Status.AVAILABLE
    assert c.on_available(2) is None
    assert c.status[2] == Status.AVAILABLE


def test_started_running_feeds_waiting_available():
    c = CenterState(num_workers=3)
    c.status[3] = Status.AVAILABLE
    assert c.on_started_running(1) == (1, 3)
    assert c.status[3] == Status.ASSIGNED


def test_cycle_check():
    c = CenterState(num_workers=2, seed=0)
    c.assigned_to[1] = 2  # 1 waits on 2, so 2 may not be fed by 1
    assert c.get_next_working_node(2) is None


def test_priority_policy_picks_heaviest():
    c = CenterState(num_workers=3, policy="priority")
    c.on_metadata(1, 5)
    c.on_metadata(3, 9)
    assert c.get_next_working_node(2) == 3


def test_all_idle():
    c = CenterState(num_workers=2)
    assert not c.all_idle()
    c.status[1] = Status.AVAILABLE
    c.status[2] = Status.ASSIGNED  # ASSIGNED counts as idle (§3.3)
    assert c.all_idle()


def test_status_values_equal_jax():
    assert {s.name: int(s) for s in Status} == {s.name: int(s) for s in jax_center.Status}


def _state(c) -> dict:
    return {
        "status": [int(s) for s in c.status],
        "best_val": c.best_val,
        "best_holder": c.best_holder,
        "metadata": list(c.metadata),
        "assigned_to": dict(c.assigned_to),
        "all_idle": c.all_idle(),
    }


@pytest.mark.parametrize("policy", ["random", "priority"])
@pytest.mark.parametrize("seed", range(8))
def test_message_stream_equals_jax(policy, seed):
    """A seeded stream of 300 center messages over 2-9 workers: every answer
    and the state after every message equal the JAX center's."""
    rng = random.Random(1000 * seed + len(policy))
    p = rng.randint(2, 9)
    ours = CenterState(num_workers=p, policy=policy, seed=seed)
    theirs = jax_center.CenterState(num_workers=p, policy=policy, seed=seed)
    for _ in range(300):
        op = rng.choice(["available", "started", "metadata", "best", "donor"])
        w = rng.randint(1, p)
        if op == "available":
            got, want = ours.on_available(w), theirs.on_available(w)
        elif op == "started":
            got, want = ours.on_started_running(w), theirs.on_started_running(w)
        elif op == "metadata":
            v = rng.randint(0, 50)
            got, want = ours.on_metadata(w, v), theirs.on_metadata(w, v)
        elif op == "best":
            v = rng.randint(0, 100)
            got, want = ours.offer_best(w, v), theirs.offer_best(w, v)
        else:
            got, want = ours.get_next_working_node(w), theirs.get_next_working_node(w)
        assert got == want, op
        assert _state(ours) == _state(theirs), op
