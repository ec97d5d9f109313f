"""The training golden of the port's card smoke, made by the JAX package.

Run as a script, it trains the qwen1.5, starcoder2, qwen3-moe, pixtral,
rwkv6, recurrentgemma and whisper smoke configs in f32 through the JAX
package on the CPU and writes ``src/repro_torch/data/golden_train.json``:

  PYTHONPATH=src python tests/test_torch_golden_train.py

Each run starts from ``repro_torch.models.convert.numpy_params(cfg,
weights_seed)`` and takes ``STEPS`` steps of JAX's training step (the
``step_fn`` of ``repro/launch/train.py``: ``jax.value_and_grad`` of
``model.loss_fn``, blockwise attention and the reference recurrence with
per-layer remat, then ``adamw_update`` with ``total_steps = STEPS``) on the
``SyntheticTokens`` batches of ``data_seed``, with the frames or patch
embeddings JAX's ``train_loop`` draws for each step.  ``peak_lr`` is raised
to 0.01 so that four warm-up steps move the weights measurably (by 1e-4 to
4e-4 an element a step).  It records
each step's loss and pre-clip gradient norm, and for every parameter leaf
(the JAX layout) the L2 norm after the steps and the L2 norm of its change.

``chip_smoke.py`` reproduces the file on the card through the kernels (in
f32: ``flash_attention``'s CUDA-core variant and ``wkv6``, each with the
plain backward).  Run as a test, it checks that the JAX package's own
``train_loop`` (its init replaced by the tree) takes the same steps, and
that the port reproduces the file on the CPU within the tolerances below,
the ones the card is held to.
"""

import dataclasses
import json
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import train as jax_train
from repro.models.registry import get_model as jax_get_model
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.train import step_inputs, train_step
from repro_torch.models import moe
from repro_torch.models.convert import export_params, load_jax_params, numpy_params
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw_init

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "src" / "repro_torch" / "data" / "golden_train.json"

STEPS = 4
RUN = dict(batch=2, seq=16, peak_lr=0.01)
# qwen3-moe's weights seed is 26: with 22 a token's second and third router
# probabilities come within 5e-6 of each other over the steps (under
# ROUTE_MARGIN)
RUNS = {
    arch: dict(arch=arch, weights_seed=w, data_seed=d, **RUN)
    for arch, w, d in (("qwen1_5_0_5b", 20, 30), ("starcoder2_3b", 21, 31),
                       ("qwen3_moe_235b_a22b", 26, 32), ("pixtral_12b", 23, 33),
                       ("rwkv6_3b", 24, 34), ("recurrentgemma_9b", 25, 35),
                       ("whisper_large_v3", 26, 36))
}
# f32 on both sides, other summation orders and, on the card, the kernels'
# forwards: the losses and gradient norms within LOSS_TOL (relative), each
# leaf's norm within LEAF_TOL and the norm of its change within CHANGE_TOL
# (relative; an element whose gradient is rounding noise can take Adam's
# step of ±lr the other way, which moves this norm, not the leaf's).  The
# key bias ``bk`` is left out of the change check: its gradient is zero in
# exact arithmetic (a shift of every key's score by q·bk leaves the softmax
# as it is), so both sides' gradients are rounding noise that Adam scales to
# ±lr.
LOSS_TOL = 1e-4
LEAF_TOL = 1e-5
CHANGE_TOL = 2e-3
# the port's smallest top-K router gap over the steps' MoE calls: far above
# the ~1e-6 by which f32 on the card may differ, so no choice flips
ROUTE_MARGIN = 1e-4


def batches(run: dict) -> list:
    """The steps' batches as numpy: the pipeline's tokens and labels, and the
    stub inputs of ``train_loop``'s step ``it``."""
    cfg = get_smoke_config(run["arch"])
    pipe = SyntheticTokens(vocab=cfg.vocab, seq_len=run["seq"] + 1,
                           global_batch=run["batch"], seed=run["data_seed"])
    out = []
    for it in range(STEPS):
        b = {k: v.numpy() for k, v in pipe.next_batch(device="cpu").items()}
        b.update({k: v.numpy() for k, v in
                  step_inputs(cfg, run["batch"], run["data_seed"], it, "cpu").items()})
        out.append(b)
    return out


def _norms(before, after) -> dict:
    """{leaf path: [|after|, |after - before|]} over a flat {path: array}."""
    return {k: [float(np.linalg.norm(after[k].astype(np.float64))),
                float(np.linalg.norm(after[k].astype(np.float64) - before[k]))]
            for k in sorted(before)}


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def jax_record(run: dict) -> dict:
    cfg = jax_smoke(run["arch"])
    model = jax_get_model(cfg)
    tree = numpy_params(get_smoke_config(run["arch"]), run["weights_seed"])

    @jax.jit
    def step_fn(params, opt, batch):  # repro/launch/train.py's step_fn
        loss, grads = jax.value_and_grad(lambda p: model.loss_fn(p, batch))(params)
        params, opt, stats = jax_adamw_update(params, grads, opt, peak_lr=run["peak_lr"],
                                              total_steps=STEPS)
        return params, opt, loss, stats["grad_norm"]

    params = jax.tree.map(jnp.asarray, tree)
    opt = jax_adamw_init(params)
    losses, gnorms = [], []
    for b in batches(run):
        params, opt, loss, gnorm = step_fn(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return {"losses": losses, "grad_norms": gnorms,
            "leaves": _norms(_flat(tree), _flat(jax.tree.map(np.asarray, params)))}


def port_record(run: dict, device="cpu") -> dict:
    """The port's record: ``train_step`` from the same tree on the same
    batches, with ``route_margin`` (inf without experts)."""
    cfg = get_smoke_config(run["arch"])
    model = get_model(cfg)
    tree = numpy_params(cfg, run["weights_seed"])
    params = load_jax_params(model.init(device=device), tree)
    opt = adamw_init({k: p.detach() for k, p in params.named_parameters()})
    margins, route = [float("inf")], moe.route

    def watched(cfg, p, x):
        r = route(cfg, p, x)
        top = r["probs"].detach().topk(cfg.top_k + 1, dim=-1).values
        margins.append(float((top[:, -2] - top[:, -1]).min()))
        return r

    losses, gnorms = [], []
    with mock.patch.object(moe, "route", watched):
        for b in batches(run):
            tb = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            opt, loss, gnorm = train_step(model, params, opt, tb, peak_lr=run["peak_lr"],
                                          total_steps=STEPS)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
    after = _flat(jax.tree.map(lambda t: t.float().cpu().numpy(), export_params(params)))
    return {"losses": losses, "grad_norms": gnorms, "leaves": _norms(_flat(tree), after),
            "route_margin": min(margins)}


def compare(got: dict, want: dict) -> dict:
    """The largest relative gap of each kind; asserts the tolerances."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    gaps = {
        "loss": max(rel(a, b) for a, b in zip(got["losses"], want["losses"])),
        "grad_norm": max(rel(a, b) for a, b in zip(got["grad_norms"], want["grad_norms"])),
        "leaf": max(rel(got["leaves"][k][0], v[0]) for k, v in want["leaves"].items()),
        "change": max(rel(got["leaves"][k][1], v[1]) for k, v in want["leaves"].items()
                      if not k.endswith("attn.bk")),
    }
    assert sorted(got["leaves"]) == sorted(want["leaves"])
    assert gaps["loss"] <= LOSS_TOL and gaps["grad_norm"] <= LOSS_TOL, gaps
    assert gaps["leaf"] <= LEAF_TOL and gaps["change"] <= CHANGE_TOL, gaps
    return gaps


def test_jax_train_loop_takes_the_golden_steps():
    """JAX's own ``train_loop`` (its init replaced by the tree, its pipeline
    and stub inputs its own) gives the golden's losses."""
    golden = json.loads(OUT.read_text())
    assert sorted(golden) == sorted(RUNS)
    for arch in ("qwen1_5_0_5b", "whisper_large_v3"):
        run = RUNS[arch]
        cfg = jax_smoke(arch)
        tree = numpy_params(get_smoke_config(arch), run["weights_seed"])
        seeded = dataclasses.replace(jax_get_model(cfg),
                                     init=lambda key: (jax.tree.map(jnp.asarray, tree), None))
        with mock.patch.object(jax_train, "get_model", lambda cfg: seeded):
            losses = jax_train.train_loop(cfg, steps=STEPS, batch=run["batch"], seq=run["seq"],
                                          peak_lr=run["peak_lr"], seed=run["data_seed"])[2]
        np.testing.assert_allclose(losses, golden[arch]["result"]["losses"], rtol=1e-6)


def test_jax_reproduces_golden_train():
    golden = json.loads(OUT.read_text())
    for arch, run in RUNS.items():
        assert {k: golden[arch][k] for k in run} == run
        got, want = jax_record(run), golden[arch]["result"]
        assert np.allclose(got["losses"], want["losses"], rtol=1e-6), arch
        compare(got, want)


def test_port_reproduces_golden_train_on_cpu():
    golden = json.loads(OUT.read_text())
    for arch, run in RUNS.items():
        got = port_record(run)
        compare(got, golden[arch]["result"])
        assert got["route_margin"] > ROUTE_MARGIN, arch


if __name__ == "__main__":
    OUT.parent.mkdir(parents=True, exist_ok=True)
    doc = {arch: {**run, "result": jax_record(run)} for arch, run in RUNS.items()}
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    for arch, d in doc.items():
        print(f"wrote {OUT} [{arch}]: losses {d['result']['losses']}")
