"""Max-clique smoke solve on the generic problem plane.

The port's mirror of ``benchmarks/clique_smoke.py``: a small batch of G(n, p)
instances solved by a max-clique ``SolverSession`` on one batched plane on
``device`` (``clique_expand`` on the card), checked against the sequential
reference.  The smoke's sizes are pinned in ``benchmarks/baseline.json``.
"""

from __future__ import annotations

import time

from repro_torch.api import SolveConfig, SolverSession
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.problems.sequential import solve_sequential_max_clique, verify_clique


def run(smoke: bool = False, device="cuda") -> dict:
    n, p, B, workers, spr = (20, 0.4, 4, 4, 8) if smoke else (32, 0.35, 8, 6, 8)
    graphs = [erdos_renyi(n, p, seed) for seed in range(B)]
    session = SolverSession(
        problem="max_clique",
        config=SolveConfig(num_workers=workers, steps_per_round=spr),
        device=device,
    )

    t0 = time.perf_counter()
    batch = session.solve_many(graphs)
    wall = time.perf_counter() - t0

    sizes = []
    for g, r in zip(graphs, batch.results):
        want, _, _ = solve_sequential_max_clique(g)
        assert r.best_size == want, (
            f"max-clique plane disagrees with the sequential reference: "
            f"{r.best_size} != {want}"
        )
        assert verify_clique(g, r.best_sol)
        assert not r.stats.overflow
        sizes.append(r.best_size)

    print(f"max_clique on G({n}, {p}) x {B}: sizes={sizes}, "
          f"{B / max(batch.wall_s, 1e-9):.2f} inst/s "
          f"(all verified vs sequential reference)")
    return dict(
        problem="max_clique",
        n=n,
        p=p,
        B=B,
        workers=workers,
        sizes=sizes,
        wall_s=round(wall, 3),
        inst_per_s=round(B / max(batch.wall_s, 1e-9), 3),
    )


if __name__ == "__main__":
    run()
