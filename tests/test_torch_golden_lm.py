"""The LM goldens of the port's card smoke, made by the JAX package.

Run as a script, it runs the qwen1.5, starcoder2 and rwkv6 smoke configs in
f32 through the JAX package on the CPU, with the weights of
``repro_torch.models.convert.numpy_params(cfg, seed)`` and seeded prompts,
and writes ``src/repro_torch/data/golden_lm.json``:

  PYTHONPATH=src python tests/test_torch_golden_lm.py

For each config it holds the last-position logits of a forward through the
Pallas kernels (interpret mode) and the greedy tokens of the JAX example's
``greedy_decode``, with the smallest gap between the best and the second
logit over the greedy steps (so a tolerance below it cannot flip a token).
``chip_smoke.py`` reproduces the file on the card through the kernels.  Run
as a test, it checks that the JAX package still reproduces the file and
that the port does on the CPU.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import rwkv6 as jax_rwkv6
from repro.models import transformer as jax_transformer
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve_lm import greedy_decode
from repro_torch.models.convert import load_jax_params, numpy_params
from repro_torch.models.registry import get_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "src" / "repro_torch" / "data" / "golden_lm.json"

# qwen's prompt seed is 101, not 100: with 100 one greedy step's best two
# logits lie 0.0005 apart, too close for a comparison at LOGITS_TOL
RUNS = {
    arch: dict(arch=arch, weights_seed=w, prompt_seed=ps, batch=2, prompt_len=10, gen=8)
    for arch, w, ps in (("qwen1_5_0_5b", 0, 101), ("starcoder2_3b", 1, 101),
                        ("rwkv6_3b", 2, 102))
}
# f32 throughout, another summation order than JAX's on the CPU
LOGITS_TOL = 1e-4


def prompts(run: dict) -> np.ndarray:
    cfg = get_smoke_config(run["arch"])
    rng = np.random.default_rng(run["prompt_seed"])
    return rng.integers(0, cfg.vocab, (run["batch"], run["prompt_len"])).astype(np.int32)


def jax_record(run: dict) -> dict:
    cfg = jax_smoke(run["arch"])
    params = jax.tree.map(jnp.asarray, numpy_params(get_smoke_config(run["arch"]),
                                                    run["weights_seed"]))
    toks = jnp.asarray(prompts(run))
    if cfg.family == "ssm":
        logits = jax_rwkv6.forward(params, cfg, toks, wkv_impl="pallas")[0]
    else:
        logits = jax_transformer.forward(params, cfg, toks, attn_impl="pallas")[0]
    spec = importlib.util.spec_from_file_location(
        "jax_serve_lm_example", ROOT / "examples" / "serve_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    model = jax_get_model(cfg)
    gen = np.asarray(example.greedy_decode(cfg, model, params, toks, run["gen"]))
    # the greedy steps' logits, for the margin of each argmax
    seq = jnp.concatenate([toks, jnp.asarray(gen[:, :-1])], axis=1)
    fwd = jax_rwkv6.forward if cfg.family == "ssm" else jax_transformer.forward
    steps = np.asarray(fwd(params, cfg, seq)[0])[:, run["prompt_len"] - 1 :]
    top2 = np.sort(steps, axis=-1)[..., -2:]
    return {
        "last_logits": np.asarray(logits[:, -1], np.float32).tolist(),
        "tokens": gen.tolist(),
        "min_margin": float((top2[..., 1] - top2[..., 0]).min()),
    }


def port_record(run: dict) -> dict:
    cfg = get_smoke_config(run["arch"])
    model = get_model(cfg)
    params = load_jax_params(model.init(device="cpu"),
                             numpy_params(cfg, run["weights_seed"]))
    toks = torch.from_numpy(prompts(run)).long()
    logits = model.forward(params, {"tokens": toks})
    gen, _ = greedy_decode(model, params, toks, run["gen"])
    return {"last_logits": logits[:, -1].numpy(), "tokens": gen.numpy()}


def test_jax_reproduces_golden_lm():
    golden = json.loads(OUT.read_text())
    assert sorted(golden) == sorted(RUNS)
    for arch, run in RUNS.items():
        assert {k: golden[arch][k] for k in run} == run
        got, want = jax_record(run), golden[arch]["result"]
        assert got["tokens"] == want["tokens"], arch
        assert np.abs(np.array(got["last_logits"]) - np.array(want["last_logits"])).max() < 1e-5
        assert want["min_margin"] > 10 * LOGITS_TOL, arch


def test_port_reproduces_golden_lm_on_cpu():
    golden = json.loads(OUT.read_text())
    for arch, run in RUNS.items():
        got, want = port_record(run), golden[arch]["result"]
        assert got["tokens"].tolist() == want["tokens"], arch
        assert np.abs(got["last_logits"] - np.array(want["last_logits"])).max() < LOGITS_TOL


if __name__ == "__main__":
    OUT.parent.mkdir(parents=True, exist_ok=True)
    doc = {arch: {**run, "result": jax_record(run)} for arch, run in RUNS.items()}
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    for arch, d in doc.items():
        print(f"wrote {OUT} [{arch}]: tokens {d['result']['tokens']}, "
              f"min margin {d['result']['min_margin']:.4f}")
