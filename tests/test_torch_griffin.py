"""The port's Griffin (recurrentgemma) against the JAX package's, on the CPU.

The same numpy inputs, and the weights of ``numpy_params`` loaded into both
packages, go through ``repro.models.griffin`` and
``repro_torch.models.griffin`` at the recurrentgemma smoke config (f32: 5
layers, one unit of rec, rec, attn and a tail of rec, rec; window 16):

* ``rglru`` (the scan and the one-token decode step, with and without a
  state) and ``causal_conv`` within 1e-5; the Hillis–Steele ``linear_scan``
  against a sequential loop, the plain reference, within 1e-6 relative (the
  two orders of association differ in the last f32 bits);
* the forward within 1e-5, also cut to 2 and 3 layers (no full unit; one
  unit and no tail);
* teacher-forced decode over 40 tokens at window 16, which wraps the
  16-slot ring twice, against JAX's ``decode_fn`` step by step (logits within
  1e-5, every cache leaf at the end) and against the forward within 2e-4
  (JAX's own gap is 2.6e-6);
* the greedy tokens of ``serve_lm.greedy_decode`` equal to the JAX example's;
* the converter's tree and the decode cache against JAX's shapes, and Λ
  against JAX's init.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import griffin as jax_griffin
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import griffin
from repro_torch.models.convert import load_jax_params, numpy_params, param_shapes
from repro_torch.models.registry import get_model


@pytest.fixture(autouse=True)
def _serving_without_grad():
    """Serving runs without autograd; the parameters require grad."""
    with torch.no_grad():
        yield


ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "recurrentgemma_9b"
B = 2
TOL = 1e-5


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_lm_example", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(seed: int = 0, n_layers: int | None = None):
    """(JAX cfg, JAX params, port Model, port params) on the same weights."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    tree = numpy_params(cfg, seed)
    model = get_model(cfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), model, load_jax_params(model.init(device="cpu"), tree)


def tokens(cfg, seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(np.int32)


def err(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def rnn_inputs(T: int, dr: int, seed: int):
    """x, r, i (B, T, dr), lam (dr,), h0 (B, dr): r and i in (0, 1) as after
    the sigmoids, lam as JAX's init."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, dr)).astype(np.float32)
    r, i = (rng.uniform(0.05, 0.95, (B, T, dr)).astype(np.float32) for _ in range(2))
    lam = np.asarray(griffin.lru_lambda(dr))
    return x, r, i, lam, rng.standard_normal((B, dr)).astype(np.float32)


def sequential_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain reference: h_t = a_t h_{t-1} + b_t, one step at a time."""
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("T", [1, 2, 7, 40, 64, 100])
def test_linear_scan_matches_sequential(T):
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, T, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, T, 24)).astype(np.float32))
    a0, b0 = a.clone(), b.clone()
    got, want = griffin.linear_scan(a, b), sequential_scan(a, b)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6
    assert torch.equal(a, a0) and torch.equal(b, b0)  # the inputs are left alone


@pytest.mark.parametrize("T,with_state", [(1, True), (1, False), (7, True), (40, False), (40, True)])
def test_rglru_matches_jax(T, with_state):
    """T = 1 with a state is the decode step; otherwise the scan (JAX's
    associative_scan against the port's Hillis–Steele scan)."""
    x, r, i, lam, h0 = rnn_inputs(T, 32, seed=T + 10 * with_state)
    jh0 = jnp.asarray(h0) if with_state else None
    want_y, want_h = jax_griffin._rglru(*map(jnp.asarray, (x, r, i, lam)), jh0)
    got_y, got_h = griffin.rglru(*map(torch.from_numpy, (x, r, i, lam)),
                                 torch.from_numpy(h0) if with_state else None)
    assert got_y.shape == (B, T, 32) and got_h.shape == (B, 32) and got_h.dtype == torch.float32
    assert err(got_y, want_y) < TOL and err(got_h, want_h) < TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3 + with_state)
    x = rng.standard_normal((B, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((B, 3, 16)).astype(np.float32) if with_state else None
    want, want_tail = jax_griffin._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                               None if st is None else jnp.asarray(st))
    got, tail = griffin.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    None if st is None else torch.from_numpy(st))
    assert err(got, want) < TOL and err(tail, want_tail) == 0


def test_rec_apply_matches_jax():
    """The recurrent block with a carried state, its new state leaf for leaf."""
    jcfg, jparams, _, params = both(seed=1)
    sp, jsp = params.groups[0].sub[0].temporal, jparams["groups"]["sub"][0]["temporal"]
    jsp = jax.tree.map(lambda a: a[0], jsp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 6, jcfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((B, jcfg.d_rnn)).astype(np.float32),
             "conv": rng.standard_normal((B, jcfg.conv_width - 1, jcfg.d_rnn)).astype(np.float32)}
    want, wst = jax_griffin.rec_apply(jcfg, jsp, jnp.asarray(x),
                                      state=jax.tree.map(jnp.asarray, state))
    got, st = griffin.rec_apply(params.cfg, sp, torch.from_numpy(x),
                                state={k: torch.from_numpy(v) for k, v in state.items()})
    assert err(got, want) < TOL
    for k in ("h", "conv"):
        assert err(st[k], wst[k]) < TOL, k


@pytest.mark.parametrize("n_layers", [None, 2, 3])
def test_forward_matches_jax(n_layers):
    """The smoke config (a unit and a tail of two), 2 layers (no full unit:
    the tail alone) and 3 (one unit, no tail)."""
    jcfg, jparams, model, params = both(seed=2, n_layers=n_layers)
    toks = tokens(jcfg, seed=3, n=40)
    want = np.asarray(jax_griffin.forward(jparams, jcfg, jnp.asarray(toks))[0])
    counts.reset()
    got = model.forward(params, {"tokens": torch.from_numpy(toks).long()})
    assert counts.snapshot() == {}  # CPU tensors launch nothing
    assert got.shape == (B, 40, jcfg.vocab) and got.dtype == torch.float32
    assert err(got, want) < TOL


def _jax_cache_leaves(jcache) -> dict:
    """JAX's decode cache as the port lays it out: a list per unit."""
    out = {"tail": [jax.tree.map(np.asarray, t) for t in jcache["tail"]]}
    n = jcache["groups"][0]["h" if "h" in jcache["groups"][0] else "k"].shape[0] \
        if jcache["groups"] else 0
    out["groups"] = [[jax.tree.map(lambda a: np.asarray(a[g]), st) for st in jcache["groups"]]
                     for g in range(n)]
    return out


def test_decode_wraps_the_ring_and_matches_jax():
    """40 tokens teacher-forced at window 16: the ring wraps twice.  Step by
    step against JAX's decode_fn, every cache leaf at the end, and the whole
    walk against the forward."""
    jcfg, jparams, model, params = both(seed=4)
    assert jcfg.window == 16
    toks = tokens(jcfg, seed=5, n=40)
    jmodel = jax_get_model(jcfg)
    jdecode = jax.jit(jmodel.decode_fn)
    jcache, _ = jmodel.init_decode_cache(B, 41)
    cache = model.init_decode_cache(B, 41, device="cpu")
    assert cache["tail"][0]["h"].dtype == torch.float32
    steps = []
    for t in range(40):
        want, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t : t + 1]))
        got, cache = model.decode_fn(params, cache, torch.from_numpy(toks[:, t : t + 1]).long())
        assert got.shape == (B, 1, jcfg.vocab)
        assert err(got, want) < TOL, t
        steps.append(got)
    assert cache["len"] == int(jcache["len"]) == 40
    leaves = _jax_cache_leaves(jcache)
    for g, unit in enumerate(cache["groups"]):
        for j, st in enumerate(unit):
            for k, v in st.items():
                assert err(v, leaves["groups"][g][j][k]) < TOL, (g, j, k)
    for t, st in enumerate(cache["tail"]):
        for k, v in st.items():
            assert err(v, leaves["tail"][t][k]) < TOL, (t, k)
    full = model.forward(params, {"tokens": torch.from_numpy(toks).long()})
    assert err(torch.cat(steps, 1), full) < 2e-4


def test_ring_shorter_than_the_window():
    """max_len under the window: the ring has max_len slots, as JAX's
    ``wlen = min(window, max_len)``; decode still equals JAX's."""
    jcfg, jparams, model, params = both(seed=6)
    toks = tokens(jcfg, seed=7, n=12)
    jmodel = jax_get_model(jcfg)
    jcache, _ = jmodel.init_decode_cache(B, 12)
    cache = model.init_decode_cache(B, 12, device="cpu")
    assert cache["groups"][0][2]["k"].shape[1] == 12
    for t in range(12):
        want, jcache = jmodel.decode_fn(jparams, jcache, jnp.asarray(toks[:, t : t + 1]))
        got, cache = model.decode_fn(params, cache, torch.from_numpy(toks[:, t : t + 1]).long())
        assert err(got, want) < TOL, t


def test_greedy_tokens_equal_jax():
    jcfg, jparams, model, params = both(seed=8)
    prompts = tokens(jcfg, seed=9, n=10)
    want = np.asarray(_jax_example().greedy_decode(
        jcfg, jax_get_model(jcfg), jparams, jnp.asarray(prompts), 12))
    got, prompt_logits = serve_lm.greedy_decode(model, params, torch.from_numpy(prompts).long(), 12)
    assert got.shape == (B, 12) and (got.numpy() == want).all()  # 22 tokens: the ring wraps
    full = model.forward(params, {"tokens": torch.from_numpy(prompts).long()})
    assert err(prompt_logits, full[:, -1]) < 2e-4


def named(tree) -> dict:
    """A tree's leaves by dotted path (dict keys and list indices)."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    key = lambda p: str(p.key) if hasattr(p, "key") else str(p.idx)
    return {".".join(key(p) for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("smoke,n_layers", [(True, None), (True, 2), (False, None)])
def test_converter_tree_matches_jax_init(smoke, n_layers):
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    jcfg = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    abstract = named(jax.eval_shape(lambda k: jax_griffin.init_lm(k, jcfg)[0], jax.random.key(0)))
    spec = named(param_shapes(cfg))
    assert {k: v[0] for k, v in spec.items()} == {k: a.shape for k, a in abstract.items()}
    # the port's modules hold every leaf, the groups split per unit
    module = get_model(cfg).init(device="meta")
    want = {}
    for name, leaf in abstract.items():
        if name.startswith("groups."):
            for g in range(leaf.shape[0]):
                want[f"groups.{g}.{name[7:]}"] = (tuple(leaf.shape[1:]), leaf.dtype)
        else:
            want[name] = (tuple(leaf.shape), leaf.dtype)
    got = {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}
    assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in want.items()}
    # the leaves JAX keeps in f32 stay f32 in a bf16 model
    f32 = {k for k, (_, dt) in want.items() if dt == jnp.float32}
    assert {k for k, (_, dt) in got.items() if dt == torch.float32} == f32
    assert any(k.endswith(".lam") for k in f32) and any(k.endswith(".b_a") for k in f32)


def test_lam_and_numpy_params_match_jax_init():
    """Λ against JAX's init within 1e-4: JAX computes it in f32, where the
    last bit of a near 0.999 moves Λ (about -9 there) by up to ~6e-5; the port
    rounds the f64 value once.  numpy_params holds the port's Λ exactly."""
    cfg = get_smoke_config(ARCH)
    jparams, _ = jax_griffin.init_lm(jax.random.key(0), jax_smoke(ARCH))
    jlam = np.asarray(jparams["groups"]["sub"][0]["temporal"]["lam"][0])
    lam = griffin.lru_lambda(cfg.d_rnn)
    assert lam.dtype == torch.float32 and np.abs(lam.numpy() - jlam).max() < 1e-4
    tree = numpy_params(cfg, 0)
    assert np.array_equal(tree["groups"]["sub"][1]["temporal"]["lam"], lam.numpy()[None])
    assert np.array_equal(tree["tail"][0]["sub"][0]["temporal"]["lam"], lam.numpy())
    spec = named(jax.eval_shape(lambda k: jax_griffin.init_lm(k, jax_smoke(ARCH))[0],
                                jax.random.key(0)))
    assert {k: (a.shape, a.dtype) for k, a in named(tree).items()} == \
        {k: (a.shape, a.dtype) for k, a in spec.items()}


@pytest.mark.parametrize("max_len", [8, 40])
def test_decode_cache_matches_jax_layout(max_len):
    cfg = get_smoke_config(ARCH)
    jcache, _ = jax_griffin.init_decode_cache(jax_smoke(ARCH), B, max_len)
    cache = griffin.init_decode_cache(cfg, B, max_len)
    leaves = _jax_cache_leaves(jcache)
    n_groups, tail = griffin.plan(cfg)
    assert len(cache["groups"]) == n_groups == 1 and tail == ("rec", "rec")
    for got_unit, want_unit in zip(cache["groups"], leaves["groups"]):
        for got, want in zip(got_unit, want_unit):
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: v.shape for k, v in want.items()}
    for got, want in zip(cache["tail"], leaves["tail"]):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_bf16_model_keeps_the_rnn_in_f32():
    """In a bf16 model r, i and the recurrence are f32 (JAX promotes the bf16
    products by the f32 biases); the block's output and y are bf16."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    model = griffin.init_lm(cfg, torch.Generator().manual_seed(0))
    rb = model.groups[0].sub[0].temporal
    assert rb.w_a.dtype == torch.bfloat16 and rb.b_a.dtype == rb.lam.dtype == torch.float32
    x = torch.randn((B, 5, cfg.d_model), generator=torch.Generator().manual_seed(1)).bfloat16()
    out, st = griffin.rec_apply(cfg, rb, x)
    assert out.dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16
    logits = griffin.forward(model, torch.zeros((B, 5), dtype=torch.long))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("layers", [None, 2])
def test_serve_lm_cli_hybrid(capsys, layers):
    argv = ["--smoke", "--device", "cpu", "--arch", "recurrentgemma-9b", "--batch", "2",
            "--prompt-len", "5", "--gen", "3"]
    if layers is not None:
        argv += ["--layers", str(layers)]
    out = serve_lm.main(argv)
    cfg = get_smoke_config(ARCH)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"[serve_lm] {cfg.name} on cpu: prefill (2, 5) in ")
    assert lines[1].startswith("[serve_lm] generated (2, 3) in ")
    assert out["tokens"].shape == (2, 3) and out["logits"].shape == (2, 5, cfg.vocab)
    assert bool(torch.isfinite(out["logits"]).all())
