"""The LM goldens of the port's card smoke, made by the JAX package.

Run as a script, it runs the qwen1.5, starcoder2, rwkv6, qwen3-moe,
llama4-scout, pixtral, recurrentgemma and whisper smoke configs in f32
through the JAX package on the CPU, with the weights of
``repro_torch.models.convert.numpy_params(cfg, seed)``, seeded prompts, for
pixtral seeded patch embeddings (``convert.patch_embeds(cfg, batch,
patch_seed)``) and for whisper seeded frames (``convert.frames(cfg, batch,
frames_seed)``), and writes ``src/repro_torch/data/golden_lm.json``:

  PYTHONPATH=src python tests/test_torch_golden_lm.py

For each config it holds the last-position logits of a forward through the
Pallas kernels (interpret mode; pixtral's with its patch prefix; Griffin's
and Whisper's forwards take no ``attn_impl`` and run JAX's blockwise
default) and the greedy tokens of the JAX example's ``greedy_decode`` (for
whisper its loop with the cache primed from the run's frames, where the
example primes zeros), with the smallest gap between the best and the
second logit over the greedy steps (so a tolerance below it cannot flip a
token).  The dense, rwkv6 and Griffin entries take those steps' logits from
the forward, which equals their decode path; the MoE, VLM and whisper
entries from the decode path itself, which is what greedy decode saw: MoE
decode drops assignments the forward keeps (C = 1 a step at cf 1.25,
``repro/models/moe.py:129``), VLM decode sees no patch prefix, and whisper's
differs from the forward in the last f32 bits.  recurrentgemma's 10 + 8
tokens wrap its 16-slot window ring.
``chip_smoke.py`` reproduces the file on the card through the kernels.  Run
as a test, it checks that the JAX package still reproduces the file and
that the port does on the CPU.
"""

import importlib.util
import json
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import encdec as jax_encdec
from repro.models import griffin as jax_griffin
from repro.models import rwkv6 as jax_rwkv6
from repro.models import transformer as jax_transformer
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve_lm import greedy_decode
from repro_torch.models import moe
from repro_torch.models.convert import frames, load_jax_params, numpy_params, patch_embeds
from repro_torch.models.registry import get_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "src" / "repro_torch" / "data" / "golden_lm.json"

# qwen's prompt seed is 101, not 100: with 100 one greedy step's best two
# logits lie 0.0005 apart, too close for a comparison at LOGITS_TOL.
# whisper's weights seed is 10: with 7-9 its greedy walk repeats one or two
# tokens (the frames dominate random weights), which pins little
RUNS = {
    arch: dict(arch=arch, weights_seed=w, prompt_seed=ps, batch=2, prompt_len=10, gen=8)
    for arch, w, ps in (("qwen1_5_0_5b", 0, 101), ("starcoder2_3b", 1, 101),
                        ("rwkv6_3b", 2, 102), ("qwen3_moe_235b_a22b", 3, 103),
                        ("llama4_scout_17b_16e", 4, 104), ("pixtral_12b", 5, 105),
                        ("recurrentgemma_9b", 6, 107), ("whisper_large_v3", 10, 108))
}
RUNS["pixtral_12b"]["patch_seed"] = 106
RUNS["whisper_large_v3"]["frames_seed"] = 109
# f32 throughout, another summation order than JAX's on the CPU
LOGITS_TOL = 1e-4
# the port's smallest gap between a token's K-th and (K+1)-th router
# probability over every MoE layer of the forward and of greedy decode: far
# above the ~1e-6 by which f32 on the card may differ, so no choice flips
ROUTE_MARGIN = 1e-4


def patches(run: dict):
    """The run's patch embeddings (numpy), or None."""
    if "patch_seed" not in run:
        return None
    return patch_embeds(get_smoke_config(run["arch"]), run["batch"], run["patch_seed"])


def run_frames(run: dict):
    """The run's frame embeddings (numpy), or None."""
    if "frames_seed" not in run:
        return None
    return frames(get_smoke_config(run["arch"]), run["batch"], run["frames_seed"])


def prompts(run: dict) -> np.ndarray:
    cfg = get_smoke_config(run["arch"])
    rng = np.random.default_rng(run["prompt_seed"])
    return rng.integers(0, cfg.vocab, (run["batch"], run["prompt_len"])).astype(np.int32)


def jax_record(run: dict) -> dict:
    cfg = jax_smoke(run["arch"])
    params = jax.tree.map(jnp.asarray, numpy_params(get_smoke_config(run["arch"]),
                                                    run["weights_seed"]))
    toks = jnp.asarray(prompts(run))
    fr = run_frames(run)
    if cfg.family == "ssm":
        logits = jax_rwkv6.forward(params, cfg, toks, wkv_impl="pallas")[0]
    elif cfg.family == "hybrid":
        logits = jax_griffin.forward(params, cfg, toks)[0]
    elif cfg.family == "encdec":
        logits = jax_encdec.forward(params, cfg, toks, frames=jnp.asarray(fr))[0]
    else:
        pe = patches(run)
        logits = jax_transformer.forward(params, cfg, toks, attn_impl="pallas",
                                         extra_embeds=None if pe is None else jnp.asarray(pe))[0]
    spec = importlib.util.spec_from_file_location(
        "jax_serve_lm_example", ROOT / "examples" / "serve_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    model = jax_get_model(cfg)

    def primed_cache():
        cache, _ = model.init_decode_cache(run["batch"], run["prompt_len"] + run["gen"] + 1)
        if fr is not None:
            cache = jax_encdec.prime_cross_cache(params, cfg, cache, jnp.asarray(fr))
        return cache

    if fr is None:
        gen = np.asarray(example.greedy_decode(cfg, model, params, toks, run["gen"]))
    else:  # the example's loop, the cache primed with the run's frames
        cache, decode, out = primed_cache(), jax.jit(model.decode_fn), []
        for t in range(run["prompt_len"]):
            step, cache = decode(params, cache, toks[:, t : t + 1])
        for _ in range(run["gen"]):
            out.append(jnp.argmax(step[:, -1], axis=-1)[:, None].astype(jnp.int32))
            step, cache = decode(params, cache, out[-1])
        gen = np.asarray(jnp.concatenate(out, axis=1))
    # the greedy steps' logits, for the margin of each argmax
    seq = jnp.concatenate([toks, jnp.asarray(gen[:, :-1])], axis=1)
    if cfg.family in ("moe", "vlm", "encdec"):  # the decode path's own logits
        cache = primed_cache()
        decode, outs = jax.jit(model.decode_fn), []
        for t in range(seq.shape[1]):
            step, cache = decode(params, cache, seq[:, t : t + 1])
            outs.append(np.asarray(step))
        steps = np.concatenate(outs, axis=1)[:, run["prompt_len"] - 1 :]
    else:
        fwd = {"ssm": jax_rwkv6.forward, "hybrid": jax_griffin.forward}.get(
            cfg.family, jax_transformer.forward)
        steps = np.asarray(fwd(params, cfg, seq)[0])[:, run["prompt_len"] - 1 :]
    assert (steps.argmax(-1) == gen).all()
    top2 = np.sort(steps, axis=-1)[..., -2:]
    return {
        "last_logits": np.asarray(logits[:, -1], np.float32).tolist(),
        "tokens": gen.tolist(),
        "min_margin": float((top2[..., 1] - top2[..., 0]).min()),
    }


def port_record(run: dict) -> dict:
    """The port's record on the CPU, with ``route_margin``: the smallest
    gap between a token's K-th and (K+1)-th router probability over every
    MoE call of the forward and greedy decode (inf without experts)."""
    cfg = get_smoke_config(run["arch"])
    model = get_model(cfg)
    params = load_jax_params(model.init(device="cpu"),
                             numpy_params(cfg, run["weights_seed"]))
    toks = torch.from_numpy(prompts(run)).long()
    batch = {"tokens": toks}
    if patches(run) is not None:
        batch["patch_embeds"] = torch.from_numpy(patches(run))
    if run_frames(run) is not None:
        batch["frames"] = torch.from_numpy(run_frames(run))
    margins = [float("inf")]
    route = moe.route

    def watched(cfg, p, x):
        r = route(cfg, p, x)
        top = r["probs"].topk(cfg.top_k + 1, dim=-1).values
        margins.append(float((top[:, -2] - top[:, -1]).min()))
        return r

    with mock.patch.object(moe, "route", watched):
        logits = model.forward(params, batch)
        gen, _ = greedy_decode(model, params, toks, run["gen"], frames=batch.get("frames"))
    return {"last_logits": logits[:, -1].numpy(), "tokens": gen.numpy(),
            "route_margin": min(margins)}


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
        assert got["route_margin"] > ROUTE_MARGIN, arch


if __name__ == "__main__":
    OUT.parent.mkdir(parents=True, exist_ok=True)
    doc = {arch: {**run, "result": jax_record(run)} for arch, run in RUNS.items()}
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    for arch, d in doc.items():
        print(f"wrote {OUT} [{arch}]: tokens {d['result']['tokens']}, "
              f"min margin {d['result']['min_margin']:.4f}")
