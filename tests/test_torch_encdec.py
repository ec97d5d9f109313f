"""The port's encoder-decoder (Whisper) against the JAX package's, on the CPU.

The same weights (``numpy_params``, loaded into both packages), tokens and
stub frames (``convert.frames``) go through ``repro.models.encdec`` and
``repro_torch.models.encdec`` at the whisper smoke config (f32: 2 + 2
layers, 24 frames), within 1e-5 unless stated:

* ``sinusoid`` and ``encode`` (bidirectional attention over the frames);
* ``prime_cross_cache``, leaf for leaf;
* the forward;
* decode primed with the forward's frames, step by step against JAX's
  ``decode_fn`` and against the forward (2e-4, JAX's own gap 1.8e-6), and
  its greedy tokens;
* the JAX example's zero-frame priming (``examples/serve_lm.py:33``): its
  greedy tokens equal the port's ``greedy_decode`` given no frames, and
  such a decode is the forward over zero frames, not over the prompt's own;
* ``decode_fn`` reads the cross K/V whatever ``primed`` says, as JAX's;
* the converter's tree against ``jax.eval_shape(init_lm)`` and the CLI.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import encdec as jax_encdec
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import encdec
from repro_torch.models.convert import frames, load_jax_params, numpy_params, param_shapes
from repro_torch.models.registry import get_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "whisper_large_v3"
B, S = 2, 12
TOL = 1e-5


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_lm_example", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(seed: int = 0):
    """(JAX cfg, JAX params, port Model, port params) on the same weights."""
    cfg = get_smoke_config(ARCH)
    tree = numpy_params(cfg, seed)
    model = get_model(cfg)
    return (jax_smoke(ARCH), jax.tree.map(jnp.asarray, tree), model,
            load_jax_params(model.init(device="cpu"), tree))


def tokens(cfg, seed: int, n: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def err(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


def jax_greedy(jcfg, jparams, prompts, gen, fr):
    """The JAX example's greedy loop with the cache primed from ``fr``:
    (tokens, the decode path's logits at the last prompt token)."""
    jmodel = jax_get_model(jcfg)
    cache, _ = jmodel.init_decode_cache(B, prompts.shape[1] + gen + 1)
    cache = jax_encdec.prime_cross_cache(jparams, jcfg, cache, jnp.asarray(fr))
    decode = jax.jit(jmodel.decode_fn)
    for i in range(prompts.shape[1]):
        logits, cache = decode(jparams, cache, jnp.asarray(prompts[:, i : i + 1]))
    last, out = np.asarray(logits[:, -1]), []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for _ in range(gen):
        out.append(tok)
        logits, cache = decode(jparams, cache, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return np.asarray(jnp.concatenate(out, axis=1)), last


@pytest.mark.parametrize("S_,d,tol", [(24, 64, 1e-5), (1500, 1280, 2.5e-4)])
def test_sinusoid_matches_jax(S_, d, tol):
    """At 1,500 positions the angle reaches 1,499 rad, whose f32 ulp is
    1.2e-4: a last-bit difference in either package's power moves sin and cos
    by up to that, so the tolerance follows the angle."""
    assert err(encdec.sinusoid(S_, d), jax_encdec._sinusoid(S_, d)) < tol


def test_encode_matches_jax():
    jcfg, jparams, _, params = both(seed=1)
    fr = frames(jcfg, B, 2)
    want = jax_encdec.encode(jparams, jcfg, jnp.asarray(fr))
    counts.reset()
    got = encdec.encode(params, t(fr))
    assert counts.snapshot() == {}
    assert got.shape == (B, jcfg.enc_seq, jcfg.d_model) and err(got, want) < TOL


def test_prime_cross_cache_leaf_for_leaf():
    jcfg, jparams, model, params = both(seed=3)
    fr = frames(jcfg, B, 4)
    jcache, _ = jax_get_model(jcfg).init_decode_cache(B, 16)
    want = jax_encdec.prime_cross_cache(jparams, jcfg, jcache, jnp.asarray(fr))
    cache = model.init_decode_cache(B, 16, device="cpu")
    assert not cache["primed"]
    got = encdec.prime_cross_cache(params, cache, t(fr))
    assert got["primed"] and bool(want["primed"])
    assert set(got) == set(want)
    for k in ("k", "v", "xk", "xv"):
        assert tuple(got[k].shape) == want[k].shape, k
        assert err(got[k], want[k]) < TOL, k
    assert got["len"] == int(want["len"]) == 0
    assert not cache["primed"]  # a new dict; the unprimed one stays as it was


def test_forward_matches_jax():
    jcfg, jparams, model, params = both(seed=5)
    toks, fr = tokens(jcfg, 6), frames(jcfg, B, 7)
    want = np.asarray(jax_encdec.forward(jparams, jcfg, jnp.asarray(toks),
                                         frames=jnp.asarray(fr))[0])
    got = model.forward(params, {"tokens": t(toks), "frames": t(fr)})
    assert got.shape == (B, S, jcfg.vocab) and got.dtype == torch.float32
    assert err(got, want) < TOL
    with pytest.raises(ValueError, match="needs frames"):
        encdec.forward(params, t(toks))


def test_decode_primed_with_the_frames_matches_jax_and_forward():
    jcfg, jparams, model, params = both(seed=8)
    toks, fr = tokens(jcfg, 9), frames(jcfg, B, 10)
    jmodel = jax_get_model(jcfg)
    jdecode = jax.jit(jmodel.decode_fn)
    jcache, _ = jmodel.init_decode_cache(B, 16)
    jcache = jax_encdec.prime_cross_cache(jparams, jcfg, jcache, jnp.asarray(fr))
    cache = encdec.prime_cross_cache(params, model.init_decode_cache(B, 16, device="cpu"), t(fr))
    full = model.forward(params, {"tokens": t(toks), "frames": t(fr)})
    steps = []
    for i in range(S):
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, i : i + 1]))
        got, cache = model.decode_fn(params, cache, t(toks[:, i : i + 1]))
        assert got.shape == (B, 1, jcfg.vocab) and err(got, want) < TOL, i
        steps.append(got)
    for k in ("k", "v"):
        assert err(cache[k], jcache[k]) < TOL, k
    assert cache["len"] == int(jcache["len"]) == S
    assert err(torch.cat(steps, 1), full) < 2e-4


def test_greedy_tokens_with_the_frames_equal_jax():
    jcfg, jparams, model, params = both(seed=11)
    prompts, fr = tokens(jcfg, 12, n=6), frames(jcfg, B, 13)
    want, want_last = jax_greedy(jcfg, jparams, prompts, 8, fr)
    got, last = serve_lm.greedy_decode(model, params, t(prompts), 8, frames=t(fr))
    assert (got.numpy() == want).all() and err(last, want_last) < TOL
    full = model.forward(params, {"tokens": t(prompts), "frames": t(fr)})
    assert err(last, full[:, -1]) < 2e-4


@pytest.mark.parametrize("n,gen", [(6, 8), (1, 4)])
def test_zero_frame_priming_of_the_jax_example(n, gen):
    """The JAX example primes the cross cache with zero frames
    (``examples/serve_lm.py:33``), so its greedy decode ignores the audio.
    ``greedy_decode`` without frames does the same: equal tokens, a decode
    that is the forward over zero frames, and far from the forward over the
    prompt's own frames.  A one-token prompt decodes straight from the
    primed cache."""
    jcfg, jparams, model, params = both(seed=14)
    prompts, fr = tokens(jcfg, 15, n=n), frames(jcfg, B, 16)
    want = np.asarray(_jax_example().greedy_decode(
        jcfg, jax_get_model(jcfg), jparams, jnp.asarray(prompts), gen))
    got, last = serve_lm.greedy_decode(model, params, t(prompts), gen)
    assert (got.numpy() == want).all()
    zeros = torch.zeros((B, jcfg.enc_seq, jcfg.d_model))
    assert err(last, model.forward(params, {"tokens": t(prompts), "frames": zeros})[:, -1]) < 2e-4
    assert err(last, model.forward(params, {"tokens": t(prompts), "frames": t(fr)})[:, -1]) > 0.1


def test_decode_reads_the_cross_cache_whatever_primed_says():
    """JAX's decode_fn never checks ``primed``: a primed cache with the flag
    cleared decodes as the primed one, and an unprimed cache attends over
    zero cross K/V."""
    jcfg, jparams, model, params = both(seed=17)
    toks, fr = tokens(jcfg, 18, n=3), frames(jcfg, B, 19)
    primed = encdec.prime_cross_cache(params, model.init_decode_cache(B, 4, device="cpu"), t(fr))
    flag_off = {**primed, "k": primed["k"].clone(), "v": primed["v"].clone(), "primed": False}
    a = model.decode_fn(params, primed, t(toks[:, :1]))[0]
    b = model.decode_fn(params, flag_off, t(toks[:, :1]))[0]
    assert torch.equal(a, b)
    jmodel = jax_get_model(jcfg)
    jcache, _ = jmodel.init_decode_cache(B, 4)
    want = jmodel.decode_fn(jparams, jcache, jnp.asarray(toks[:, :1]))[0]
    got = model.decode_fn(params, model.init_decode_cache(B, 4, device="cpu"), t(toks[:, :1]))[0]
    assert err(got, want) < TOL


def named(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {".".join(str(p.key) for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("smoke", [True, False])
def test_converter_tree_matches_jax_init(smoke):
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    jcfg = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    abstract = named(jax.eval_shape(lambda k: jax_encdec.init_lm(k, jcfg)[0], jax.random.key(0)))
    spec = named(param_shapes(cfg))
    assert {k: v[0] for k, v in spec.items()} == {k: a.shape for k, a in abstract.items()}
    module = get_model(cfg).init(device="meta")
    want = {}
    for name, leaf in abstract.items():
        head, _, rest = name.partition(".")
        if head in ("enc_blocks", "dec_blocks"):
            for i in range(leaf.shape[0]):
                want[f"{head}.{i}.{rest}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    if smoke:
        tree = named(numpy_params(cfg, 0))
        assert {k: (a.shape, a.dtype) for k, a in tree.items()} == \
            {k: (a.shape, a.dtype) for k, a in abstract.items()}


def test_frames_are_seeded():
    cfg = get_smoke_config(ARCH)
    a, b = frames(cfg, 3, 5), frames(cfg, 3, 5)
    assert a.shape == (3, cfg.enc_seq, cfg.d_model) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, frames(cfg, 3, 6))


@pytest.mark.parametrize("layers", [None, 1])
def test_serve_lm_cli_encdec(capsys, layers):
    """The prefill carries seeded frames and decode is primed with them;
    ``--layers`` cuts the encoder and the decoder alike."""
    argv = ["--smoke", "--device", "cpu", "--arch", "whisper-large-v3", "--batch", "2",
            "--prompt-len", "5", "--gen", "3"]
    if layers is not None:
        argv += ["--layers", str(layers)]
    out = serve_lm.main(argv)
    cfg = serve_lm.cut_depth(get_smoke_config(ARCH), layers)
    assert (cfg.n_layers, cfg.n_enc_layers) == ((2, 2) if layers is None else (1, 1))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[serve_lm] {cfg.name} on cpu: prefill (2, 5) in ")
    assert out["tokens"].shape == (2, 3) and out["logits"].shape == (2, 5, cfg.vocab)
    # the CLI's greedy decode heard the prompt's frames: its first token is
    # the forward's argmax at the last prompt position
    assert torch.equal(out["tokens"][:, 0], out["logits"][:, -1].argmax(-1))

