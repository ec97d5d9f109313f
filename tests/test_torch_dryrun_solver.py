"""The solver's collective bytes (``launch/dryrun_solver.py``) against JAX's.

JAX's ``repro.launch.dryrun_solver.lower_engine`` lowers one superstep of
the SPMD engine on a mesh of forced host devices and parses the collectives
from the HLO; the port runs one superstep with one worker a rank and counts
what its mesh issues, in the same convention (result bytes, an all-reduce's
×2, by kind, with counts).  For the four control planes (baseline, packed
status word, + skip-empty, + sparse data plane):

* on 4 gloo ranks on the CPU, and on the dry stand-in of a 4-rank mesh,
  the bytes and counts equal JAX's ``lower_engine(64, 4, ...)`` exactly:
  totals 136, 112, 112 and 192 B;
* the dry stand-in of JAX's default (n 1024, 512 workers) equals
  ``lower_engine(1024, 512, ...)``;
* one chunk (``--chunked``) issues one superstep's collectives a superstep
  it ran (JAX's mesh chunk does not lower on jax 0.9.0: no JAX oracle).

JAX runs in a subprocess: ``repro.launch.dryrun_solver`` sets XLA_FLAGS to
512 host devices at import, so it is never imported in the test process.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun_solver
from repro_torch.launch.mesh import spawn_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
SIZES = [(64, 4), (1024, 512)]
TOTALS_64_4 = [136, 112, 112, 192]

_JAX_SCRIPT = r"""
import json, sys
from repro.launch.dryrun_solver import lower_engine
out = {}
for n, w in json.loads(sys.argv[1]):
    rows = []
    for packed, skip, impl in json.loads(sys.argv[2]):
        r = lower_engine(n, w, packed_status=packed, skip_empty_transfer=skip,
                         transfer_impl=impl)
        rows.append({"collectives": r["collectives"], "counts": r["collective_counts"]})
    out[f"{n}/{w}"] = rows
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counted():
    """(JAX's rows by size, the real 4-rank group's, the chunk on both)."""
    variants = [[p, s, i] for p, s, i, _ in dryrun_solver.VARIANTS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, json.dumps(SIZES), json.dumps(variants)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        real = spawn_mesh(dryrun_solver.real_variants, 4, device="cpu", timeout_s=TIMEOUT_S,
                          args=(64, {}))
        chunk = spawn_mesh(dryrun_solver.real_variants, 4, device="cpu", timeout_s=TIMEOUT_S,
                           args=(64, {"chunked": True, "chunk_rounds": 4}))
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1]), real, chunk


def _same_as_jax(rows, want):
    for r, w in zip(rows, want, strict=True):
        assert r["data_plane"], r  # the matched round JAX's static count includes
        assert r["collectives"] == w["collectives"], (r["label"], r["collectives"], w)
        assert r["collective_counts"] == w["counts"], r["label"]


def test_real_group_equals_jax(counted):
    want, real, _ = counted
    assert all(r == real[0] for r in real[1:])  # every rank counts the same
    _same_as_jax(real[0], want["64/4"])
    assert [r["collectives"]["total"] for r in real[0]] == TOTALS_64_4
    assert {r["mesh"] for r in real[0]} == {"gloo"}


@pytest.mark.parametrize("n,workers", SIZES, ids=lambda v: str(v))
def test_dry_stand_in_equals_jax(counted, n, workers):
    want, _, _ = counted
    rows = dry_rows(n, workers)
    _same_as_jax(rows, want[f"{n}/{workers}"])
    assert {r["mesh"] for r in rows} == {"dry"}


def test_dry_stand_in_equals_the_real_group(counted):
    _, real, _ = counted
    strip = lambda rows: [{k: v for k, v in r.items() if k != "mesh"} for r in rows]  # noqa: E731
    assert strip(dry_rows(64, 4)) == strip(real[0])


def test_one_chunk_counts_its_supersteps(counted):
    """A chunk of the unconditional control planes issues one superstep's
    collectives for every superstep it ran; the skipping ones no more."""
    _, real, chunk = counted
    assert all(r == chunk[0] for r in chunk[1:])
    for c, one in zip(chunk[0], real[0], strict=True):
        ran = c["supersteps_in_chunk"]
        assert c["chunked"] and 1 <= ran <= 4
        for kind, nbytes in one["collectives"].items():
            if one["skip_empty_transfer"]:
                assert c["collectives"][kind] <= ran * nbytes
            else:
                assert c["collectives"][kind] == ran * nbytes, (c["label"], kind)


_DRY = {}


def dry_rows(n, workers):
    if (n, workers) not in _DRY:
        _DRY[(n, workers)] = dryrun_solver.dry_variants(n, workers, "cpu")
    return _DRY[(n, workers)]


def test_cli_prints_the_four_variants(capsys):
    rows = dryrun_solver.main(["--n", "64", "--workers", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["collectives"]["total"] for r in rows] == TOTALS_64_4
    assert all(f"coll_total={t}B" in out for t in TOTALS_64_4)


@pytest.mark.parametrize("ranks", ["dry", "real"])
def test_cli_runs_on_the_card_unless_asked_for_the_cpu(ranks, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_solver.main(["--n", "64", "--workers", "4", "--ranks", ranks])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_solver.dry_variants(64, 4)
