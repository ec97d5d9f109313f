"""The port's example twins (``repro_torch.examples``) against ``examples/``.

Each twin runs on the CPU here (``--device cpu``) and prints what the JAX
example prints, line for line, less the lines that read the host's clock or
the JAX plane cache's own counters: ``quickstart``'s part 1 (the JAX
example's LM training, part 2, is stubbed out of it; the twin's part 2
trains from the port's own init, so its loss line is checked to show
learning, not equality), ``solve_dimacs``'s §4 table, transfer paths and
batched plane, its ``--spill`` and ``--files`` modes, and ``serve_solver``'s
stream.  torch runs on one CPU thread here: the suite's workers would
otherwise oversubscribe the cores.
"""

import re
import sys

import pytest
import torch

from repro_torch.examples import quickstart, serve_solver, solve_dimacs

_CLOCK = re.compile(r"\d+\.\d+s total \(\d+\.\d+ inst/s\)")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(text: str) -> list:
    return [_CLOCK.sub("", line) for line in text.splitlines() if "cache" not in line]


def test_quickstart_part_1_equals_jax(capsys, monkeypatch):
    from examples import quickstart as jax_quickstart

    assert quickstart.main(["--device", "cpu"]) is True
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jax_quickstart, "train_loop",
                        lambda cfg, **kw: (None, None, [2.0] * 6 + [1.0] * 6))
    jax_quickstart.main()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[:4] == theirs[:4]
    assert "mvc=28" in ours[3] and "verified=True" in ours[3]
    assert ours[-1].startswith("loss ") and ours[-1].endswith("(OK)")  # part 2 learned


@pytest.mark.parametrize("argv", [["30", "0.4"], ["--spill"]])
def test_solve_dimacs_equals_jax(argv, capsys, monkeypatch, tmp_path):
    from examples import solve_dimacs as jax_solve_dimacs

    solve_dimacs.main(argv + ["--device", "cpu"])
    ours = _lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["solve_dimacs.py"] + argv)
    jax_solve_dimacs.main()
    theirs = _lines(capsys.readouterr().out)
    assert ours == theirs and len(ours) >= 4


def test_solve_dimacs_files_equal_jax(capsys, monkeypatch, tmp_path):
    from examples import solve_dimacs as jax_solve_dimacs
    from repro_torch.graphs.generators import erdos_renyi, to_dimacs

    paths = []
    for s, n in enumerate((18, 21, 16)):
        p = tmp_path / f"g{s}.col"
        p.write_text(to_dimacs(erdos_renyi(n, 0.4, s)))
        paths.append(str(p))
    for problem in ("max_clique", "mis"):
        argv = ["--problem", problem, "--files", *paths]
        solve_dimacs.main(argv + ["--device", "cpu"])
        ours = _lines(capsys.readouterr().out)
        monkeypatch.setattr(sys, "argv", ["solve_dimacs.py"] + argv)
        jax_solve_dimacs.main()
        assert ours == _lines(capsys.readouterr().out)
        assert all("verified=True" in line for line in ours[1:])


def test_solve_dimacs_refuses_what_jax_refuses():
    with pytest.raises(SystemExit, match="vertex-cover only"):
        solve_dimacs.main(["--problem", "mis", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown problem"):
        solve_dimacs.main(["--problem", "tsp", "--files", "x.col", "--device", "cpu"])


def test_serve_solver_equals_jax(capsys):
    from examples import serve_solver as jax_serve_solver

    sizes = serve_solver.main(["--device", "cpu"])
    ours = _lines(capsys.readouterr().out)
    jax_serve_solver.main()
    theirs = _lines(capsys.readouterr().out)
    assert ours == theirs
    assert len(sizes) == 8


def test_serve_lm_balancer_equals_jax(capsys, monkeypatch):
    """``examples/serve_lm.py``'s twin: the same token shape and the same
    balancer line (a host simulation over the same seeded arrivals); the
    sampled tokens come from each package's own seeded init."""
    from examples import serve_lm as jax_serve_lm
    from repro_torch.examples import serve_lm

    out = serve_lm.main(["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    jax_serve_lm.main()
    theirs = capsys.readouterr().out.splitlines()
    assert tuple(out["tokens"].shape) == (4, 24)
    assert ours[0].split(" in ")[0] == theirs[0].split(" in ")[0]
    assert ours[-1] == theirs[-1] and ours[-1].startswith("[balancer] makespan")
    assert out["balanced"]["rounds"] < out["unbalanced"]["rounds"]
