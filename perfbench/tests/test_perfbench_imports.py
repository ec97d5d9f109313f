"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (``repro_torch`` begins with ``repro``), and the reference
loads nothing of the port."""

import subprocess
import sys

from conftest import ROOT

PRELUDE = f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_reference_loads_nothing_of_the_port():
    out = _run(
        "import glob, pathlib\n"
        "import perfbench.reference.expand, perfbench.reference.superstep, "
        "perfbench.reference.bits, perfbench.roofline, perfbench.instances\n"
        "from perfbench.bench import load_module\n"
        "for p in glob.glob('perfbench/reference/problems/*.py') + "
        "glob.glob('perfbench/judges/*.py'):\n"
        "    load_module(pathlib.Path(p))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    tops = set(eval(out.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    out = _run(
        "import glob, time, torch\n"
        "sys.path.insert(0, 'perfbench/tests')\n"
        "from conftest import run_tiny\n"
        "from perfbench import bench\n"
        "for p in glob.glob('perfbench/metrics/*.py') + glob.glob('perfbench/drivers/*.py'):\n"
        "    bench.load_module(__import__('pathlib').Path(p))\n"
        "run_tiny('vc-gnp600-lanes32', trace=True)\n"
        "print(bench.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    assert out.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from perfbench import bench

    fake = type(sys)("x")
    for name, bad in (("repro_torch.api", []), ("repro.core", ["repro"]),
                      ("jaxlib.xla", ["jaxlib"]), ("jaxtyping", []), ("flax", ["flax"])):
        monkeypatch.setattr(sys, "modules", {name: fake})
        assert bench.forbidden_modules() == bad


def test_run_without_a_card_exits_without_a_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "vc-gnp600-lanes32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
