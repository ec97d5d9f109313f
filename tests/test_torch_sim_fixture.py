"""The JAX-made record of the host simulators, for the port to reproduce on the card.

The cases: ``protocol_sim`` and ``centralized`` on G(300, 4/299, seed 0),
``golden_smoke.json``'s graph, at P = 32 and 128 workers with the
optimized codec and at P = 128 with the basic one (six runs a package), and
both on max clique over ``erdos_renyi(20, 0.4, seeds 0-3)`` at 8 workers;
beside them the sequential optimum of the G(300) graph, which the SPMD
engine must reach.  Run as a script, it solves every case with the JAX
package and writes ``src/repro_torch/data/golden_sim.json``: each case's
graph, config and ``SolveResult.to_dict()`` less ``wall_s`` (ticks,
failed requests, bytes, message counts and bytes by tag, the best
solution).

  PYTHONPATH=src python tests/test_torch_sim_fixture.py

``chip_smoke.py`` phase 15 reads it from the checkout.  Run as a test, it
checks that the JAX package still writes the same fixture and that the port
reproduces every case on the CPU.
"""

import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "src" / "repro_torch" / "data" / "golden_sim.json"
VC_GRAPH = {"generator": "erdos_renyi", "n": 300, "p": 4.0 / 299, "seed": 0}


def cases() -> list:
    out = []
    for workers, codec in ((32, "optimized"), (128, "optimized"), (128, "basic")):
        for backend in ("protocol_sim", "centralized"):
            out.append({"problem": "vertex_cover", "backend": backend, "graph": VC_GRAPH,
                        "solve_kw": {"num_workers": workers, "codec": codec}})
    for seed in range(4):
        for backend in ("protocol_sim", "centralized"):
            out.append({"problem": "max_clique", "backend": backend,
                        "graph": {"generator": "erdos_renyi", "n": 20, "p": 0.4, "seed": seed},
                        "solve_kw": {"num_workers": 8}})
    return out


def build_graph(generators, spec: dict):
    return getattr(generators, spec["generator"])(
        **{k: v for k, v in spec.items() if k != "generator"})


def result_dict(r) -> dict:
    d = json.loads(json.dumps(r.to_dict()))
    d.pop("wall_s")
    return d


def run_case(api, generators, case: dict, **session_kw) -> dict:
    session = api.SolverSession(problem=case["problem"], backend=case["backend"],
                                config=api.SolveConfig(**case["solve_kw"]), **session_kw)
    return result_dict(session.solve(build_graph(generators, case["graph"])))


def jax_golden() -> dict:
    from repro import api
    from repro.graphs import generators
    from repro.problems.sequential import solve_sequential

    best, _, stats = solve_sequential(build_graph(generators, VC_GRAPH))
    return {
        "sequential": {"graph": VC_GRAPH, "best_size": int(best),
                       "nodes_expanded": int(stats.nodes)},
        "cases": [{**c, "result": run_case(api, generators, c)} for c in cases()],
    }


def test_jax_still_writes_the_fixture():
    assert json.loads(GOLDEN.read_text()) == json.loads(json.dumps(jax_golden()))


def test_port_reproduces_the_fixture_on_the_cpu():
    from repro_torch import api
    from repro_torch.graphs import generators

    golden = json.loads(GOLDEN.read_text())
    assert [{k: c[k] for k in ("problem", "backend", "graph", "solve_kw")}
            for c in golden["cases"]] == cases()
    for case in golden["cases"]:
        got = run_case(api, generators, case, device="cpu")
        assert got == case["result"], (case["backend"], case["solve_kw"], case["graph"])
        if case["backend"] == "protocol_sim":
            assert got["stats"]["failed_requests"] == 0
        if case["problem"] == "vertex_cover":
            assert got["best_size"] == golden["sequential"]["best_size"]


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(jax_golden(), indent=1) + "\n")
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
