"""The live plane's lane verbs and instance writes against the JAX package.

``make_vacant_lanes``, ``lane_swap_in`` and ``lane_retire``
(``repro/core/superstep.py:771-882``) leaf for leaf through the flat layout
(``lane_state_to_flat``), and ``make_blank_batch_data``/``write_instance``
(``repro/problems/base.py:358-399``) word for word, for each problem, on a
one-word and a two-word plane.  The port writes in place; JAX returns new
arrays: the states must agree after every verb.
"""

import numpy as np
import pytest
from _torch_parity import assert_flat_equal, u32

from repro.core import engine as jax_engine
from repro.core import superstep as jss
from repro.graphs.generators import erdos_renyi
from repro.problems import base as jb
from repro.problems.registry import get_problem
from repro_torch.core import engine as torch_engine
from repro_torch.core import superstep as tss
from repro_torch.problems import base as tb
from repro_torch.problems.registry import get_problem as get_torch_problem

B, P, CAP = 3, 4, 40
PROBLEMS = ("vertex_cover", "max_clique", "mis")
# plane width W -> instance sizes admitted into it (all of that width)
SIZES = {1: (12, 20, 30), 2: (40, 50, 64)}


def _states_equal(jl, tl):
    assert_flat_equal(jss.lane_state_to_flat(jl), tss.lane_state_to_flat(tl))


@pytest.mark.parametrize("W", sorted(SIZES))
@pytest.mark.parametrize("problem", PROBLEMS)
def test_lane_verbs_match_jax(problem, W):
    jspec, tspec = get_problem(problem), get_torch_problem(problem)
    jl = jss.make_vacant_lanes(B, P, CAP, W)
    tl = tss.make_vacant_lanes(B, P, CAP, W, "cpu")
    _states_equal(jl, tl)
    assert not tl.occupied().any() and bool(tl.done.all())

    def swap(jl, tl, lane, n, seed, tag):
        g = erdos_renyi(n, 0.3, seed)
        best = jb.initial_bound(jspec, g, "bnb", None)
        assert best == tb.initial_bound(tspec, g, "bnb", None)
        jw = jax_engine.make_instance_state(jspec, g, P, CAP, W, best)
        tw = torch_engine.make_instance_state(tspec, g, P, CAP, W, best, "cpu")
        jl = jss.lane_swap_in(jl, lane, jw, tag)
        assert tss.lane_swap_in(tl, lane, tw, tag) is tl  # in place
        return jl, tl

    n0, n1, n2 = SIZES[W]
    jl, tl = swap(jl, tl, 1, n0, 0, 7)
    jl, tl = swap(jl, tl, 2, n1, 1, 9)
    _states_equal(jl, tl)
    assert list(tl.occupied()) == [False, True, True]
    jl = jss.lane_retire(jl, 1)
    assert tss.lane_retire(tl, 1) is tl
    _states_equal(jl, tl)
    # a freed lane re-admits a different instance; every leaf is overwritten
    jl, tl = swap(jl, tl, 1, n2, 2, 11)
    _states_equal(jl, tl)
    assert list(tl.tag) == [-1, 11, 9]


@pytest.mark.parametrize("W", sorted(SIZES))
@pytest.mark.parametrize("problem", PROBLEMS)
def test_write_instance_matches_jax(problem, W):
    jspec, tspec = get_problem(problem), get_torch_problem(problem)
    n_max = 32 * W
    jd = jb.make_blank_batch_data(B, n_max, W)
    td = tb.make_blank_batch_data(B, n_max, W, "cpu")
    for lane, n in ((0, SIZES[W][2]), (2, SIZES[W][0]), (0, SIZES[W][1])):
        g = erdos_renyi(n, 0.3, 10 + lane + n)
        jd = jb.write_instance(jd, lane, jspec, g)
        assert tb.write_instance(td, lane, tspec, g) is td  # in place
        assert (td.n == np.asarray(jd.n)).all()
        assert (u32(td.adj) == np.asarray(jd.adj)).all()
    assert list(td.n) == [SIZES[W][1], 0, SIZES[W][0]]
    big = erdos_renyi(n_max + 1, 0.3, 0)
    with pytest.raises(ValueError, match="exceeds the live plane"):
        tb.write_instance(td, 1, tspec, big)
