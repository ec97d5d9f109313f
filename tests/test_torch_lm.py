"""The port's LM serving path against the JAX package's, on the CPU.

On the qwen1.5, starcoder2 (GQA) and rwkv6 smoke configs in f32, the same
weights (``numpy_params``, loaded into both packages) and the same tokens go
through both packages:

* the forward logits against JAX's ``forward`` with its Pallas kernels in
  interpret mode (``attn_impl="pallas"``, ``wkv_impl="pallas"``), within
  1e-4, and the port's plain routes against JAX's defaults;
* ``decode_fn`` step by step, and rwkv6's multi-token ``decode_fn``, against
  JAX's, within 1e-4;
* the greedy tokens against the JAX example's ``greedy_decode``, exactly;
* the converter's tree against ``jax.eval_shape(init_lm)``, and the decode
  cache's clamp at a full cache; the refused families raise.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import rwkv6 as jax_rwkv6
from repro.models import transformer as jax_transformer
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import ALIASES, ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import rwkv6, transformer
from repro_torch.models.convert import load_jax_params, numpy_params, param_shapes
from repro_torch.models.registry import get_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["qwen1_5_0_5b", "starcoder2_3b", "rwkv6_3b"]
B, S = 2, 12
TOL = 1e-4


def _jax_example():
    """The JAX package's examples/serve_lm.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_lm_example", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(arch: str, seed: int = 0):
    """(JAX cfg, JAX params, port Model, port params) on the same weights."""
    cfg = get_smoke_config(arch)
    tree = numpy_params(cfg, seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = get_model(cfg)
    params = load_jax_params(model.init(device="cpu"), tree)
    return jax_smoke(arch), jparams, model, params


def tokens(cfg, seed=1, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def jax_forward(cfg, params, toks, **kw):
    fwd = jax_rwkv6.forward if cfg.family == "ssm" else jax_transformer.forward
    return np.asarray(fwd(params, cfg, jnp.asarray(toks), **kw)[0])


def port(toks) -> torch.Tensor:
    return torch.from_numpy(toks).long()


def err(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_configs_are_copies(arch):
    assert ARCH_IDS == JAX_ARCH_IDS and ALIASES == JAX_ALIASES
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(jax_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_kernel_path(arch):
    jcfg, jparams, model, params = both(arch)
    toks = tokens(jcfg)
    impl = {"wkv_impl": "pallas"} if jcfg.family == "ssm" else {"attn_impl": "pallas"}
    want = jax_forward(jcfg, jparams, toks, **impl)
    counts.reset()
    got = model.forward(params, {"tokens": port(toks)})
    assert counts.snapshot() == {}  # CPU tensors launch nothing
    assert got.shape == (B, S, jcfg.vocab) and got.dtype == torch.float32
    assert err(got, want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_routes_match_jax_defaults(arch):
    jcfg, jparams, model, params = both(arch, seed=2)
    toks = tokens(jcfg, seed=3)
    want = jax_forward(jcfg, jparams, toks)  # "blockwise" / "ref"
    if jcfg.family == "ssm":
        routes = [rwkv6.forward(params, port(toks), wkv_impl="ref")]
    else:
        routes = [transformer.forward(params, port(toks), attn_impl=i)
                  for i in ("blockwise", "ref")]
    for got in routes:
        assert err(got, want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    jcfg, jparams, model, params = both(arch, seed=4)
    toks = tokens(jcfg, seed=5)
    jmodel = jax_get_model(jcfg)
    jdecode = jax.jit(jmodel.decode_fn)
    jcache, _ = jmodel.init_decode_cache(B, 16)
    cache = model.init_decode_cache(B, 16, device="cpu")
    full = model.forward(params, {"tokens": port(toks)})
    for t in range(S):
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t : t + 1]))
        got, cache = model.decode_fn(params, cache, port(toks[:, t : t + 1]))
        assert got.shape == (B, 1, jcfg.vocab)
        assert err(got, want) < TOL, t
        # JAX's test_decode_matches_forward: the serve path is exact
        assert err(got[:, 0], full[:, t]) < 2e-4, t


def test_rwkv6_multi_token_decode_matches_jax():
    """decode_fn given several tokens runs the recurrence from the state
    (the kernel on the card); chunks of 5, 1 and 6 tokens."""
    jcfg, jparams, model, params = both("rwkv6_3b", seed=6)
    toks = tokens(jcfg, seed=7)
    jmodel = jax_get_model(jcfg)
    jcache, _ = jmodel.init_decode_cache(B, 16)
    cache = model.init_decode_cache(B, 16, device="cpu")
    outs = []
    for lo, hi in ((0, 5), (5, 6), (6, 12)):
        want, jcache = jmodel.decode_fn(jparams, jcache, jnp.asarray(toks[:, lo:hi]))
        got, cache = model.decode_fn(params, cache, port(toks[:, lo:hi]))
        assert err(got, want) < TOL, (lo, hi)
        outs.append(got)
    for name in ("wkv", "shift_t", "shift_c"):
        assert err(cache[name], jcache[name]) < TOL, name
    full = model.forward(params, {"tokens": port(toks)})
    assert err(torch.cat(outs, 1), full) < 2e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(arch):
    jcfg, jparams, model, params = both(arch, seed=8)
    prompts = tokens(jcfg, seed=9, n=6)
    want = np.asarray(_jax_example().greedy_decode(
        jcfg, jax_get_model(jcfg), jparams, jnp.asarray(prompts), 8))
    got, prompt_logits = serve_lm.greedy_decode(model, params, port(prompts), 8)
    assert got.shape == (B, 8)
    assert (got.numpy() == want).all()
    full = model.forward(params, {"tokens": port(prompts)})
    assert err(prompt_logits, full[:, -1]) < 2e-4


def named(tree, is_leaf=None) -> dict:
    """A tree's leaves by dotted path."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(p.key for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_converter_tree_matches_jax_init(arch, smoke):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    jcfg = jax_smoke(arch) if smoke else jax_get_config(arch)
    init = jax_rwkv6.init_lm if cfg.family == "ssm" else jax_transformer.init_lm
    abstract = named(jax.eval_shape(lambda k: init(k, jcfg)[0], jax.random.key(0)))
    spec = named(param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    assert {k: v[0] for k, v in spec.items()} == {k: a.shape for k, a in abstract.items()}
    # the port's modules hold every leaf, split per layer (no memory: meta)
    module = get_model(cfg).init(device="meta")
    want = {}
    for name, leaf in abstract.items():
        if name.startswith("blocks."):
            for i in range(leaf.shape[0]):
                want[f"blocks.{i}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    if smoke:  # f32 configs: numpy_params has JAX's shapes and dtypes
        tree = named(numpy_params(cfg, 0))
        assert {k: (a.shape, a.dtype) for k, a in tree.items()} == \
            {k: (a.shape, a.dtype) for k, a in abstract.items()}


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "starcoder2_3b"])
def test_cache_write_clamps_at_a_full_cache(arch):
    """dynamic_update_slice clamps its start: past the last slot, a new
    token's K/V land on the last slot.  Decode 7 tokens into a 4-slot cache."""
    jcfg, jparams, model, params = both(arch, seed=10)
    toks = tokens(jcfg, seed=11, n=7)
    jmodel = jax_get_model(jcfg)
    jdecode = jax.jit(jmodel.decode_fn)
    jcache, _ = jmodel.init_decode_cache(B, 4)
    cache = model.init_decode_cache(B, 4, device="cpu")
    for t in range(7):
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t : t + 1]))
        got, cache = model.decode_fn(params, cache, port(toks[:, t : t + 1]))
        assert err(got, want) < TOL, t
        assert err(cache["k"], jcache["k"]) < TOL, t
    assert cache["len"] == int(jcache["len"]) == 7


def test_refused_families_raise():
    for arch, item in (("qwen3_moe_235b_a22b", "14b"), ("llama4_scout_17b_16e", "14b"),
                       ("recurrentgemma_9b", "14c"), ("whisper_large_v3", "14d"),
                       ("pixtral_12b", "14e")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item {item}"):
            get_model(get_smoke_config(arch))
    with pytest.raises(NotImplementedError, match="item 14b"):
        transformer.init_lm(get_smoke_config("qwen3_moe_235b_a22b"), device="meta")
    _, _, model, params = both("qwen1_5_0_5b")
    with pytest.raises(NotImplementedError, match="item 14e"):
        transformer.forward(params, port(tokens(model.cfg)), extra_embeds=torch.zeros(B, 2, 64))
    with pytest.raises(ValueError, match="unknown attention impl"):
        transformer.forward(params, port(tokens(model.cfg)), attn_impl="pallas")


def test_seeded_init_is_deterministic():
    cfg = get_smoke_config("rwkv6_3b")
    a = rwkv6.init_lm(cfg, torch.Generator().manual_seed(3))
    b = rwkv6.init_lm(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert all(not p.requires_grad for p in a.parameters())


def test_serve_lm_cli(capsys, monkeypatch):
    out = serve_lm.main(["--smoke", "--device", "cpu", "--arch", "rwkv6-3b",
                         "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve_lm] rwkv6-smoke on cpu: prefill (2, 5) in ")
    assert lines[1].startswith("[serve_lm] generated (2, 3) in ")
    assert out["tokens"].shape == (2, 3) and out["logits"].shape == (2, 5, 512)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main(["--smoke"])
