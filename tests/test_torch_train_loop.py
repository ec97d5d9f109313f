"""The port's training loop and its checkpoints against the JAX package's,
on the CPU.

* Both directions of resume (qwen1.5 smoke, f32, batch 4 x 32, seed 3): the
  JAX ``train_loop`` writes a checkpoint at step 6 and the port's
  ``train_loop(resume=True)`` continues it to step 12, its losses within
  2e-4 of JAX's uninterrupted 12 steps (JAX's own tolerance,
  ``tests/test_checkpoint.py``); and the same with the packages swapped.
  The port's own resume reproduces its uninterrupted run exactly.
* The checkpoint's keys and dtypes are JAX's, leaf for leaf, for a
  ``(params, OptState)`` tree with stacked leaves and Griffin's ``tail``
  list (``"[0]/['blocks']/['attn']/['wq']"``, ``"[1]/.step"``,
  ``"[1]/.m/['tail']/[0]/['sub']/[0]/['ln1']"``).
* bf16: a bf16 port checkpoint stores its bf16 leaves as JAX does
  (``|V2``) and resumes exactly; a JAX-written bf16 checkpoint loads in the
  port bit for bit; JAX's own ``restore_checkpoint`` raises on a bf16 tree
  (a reference behaviour the port does not copy, pinned here).
* The port of JAX's ``tests/test_arch_smoke.py::test_one_train_step``: for
  every arch, ``train_step`` from the port's seeded init gives a finite
  loss and gradient norm and moves every parameter; in a Griffin config
  under one unit, which keeps an unused unit, AdamW's decay moves that
  unit's nonzero weights though their gradient is zero, as in JAX (its zero
  biases stay).
* The CLI and the ``train_lm`` example twin (its drift check); part 2 of the
  quickstart twin is checked with part 1 in ``test_torch_examples.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import store as jax_store
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import train as jax_train
from repro.models.registry import get_model as jax_get_model
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.checkpoint import store
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.models.convert import load_jax_params, numpy_params
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw_init

ARCH = "qwen1_5_0_5b"
RUN = dict(batch=4, seq=32, seed=3)
RESUME_TOL = 2e-4


@pytest.fixture(scope="module")
def jax_full():
    return jax_train.train_loop(jax_smoke(ARCH), steps=12, ckpt_dir=None, **RUN)[2]


@pytest.fixture(scope="module")
def port_full():
    return train.train_loop(get_smoke_config(ARCH), steps=12, device="cpu", **RUN)[2]


def test_port_resumes_a_jax_checkpoint(tmp_path, jax_full):
    ck = str(tmp_path / "ck")
    first = jax_train.train_loop(jax_smoke(ARCH), steps=6, ckpt_dir=ck, ckpt_every=3, **RUN)[2]
    jax_store.wait_for_pending()
    assert np.allclose(first, jax_full[:6], rtol=RESUME_TOL, atol=RESUME_TOL)
    second = train.train_loop(get_smoke_config(ARCH), steps=12, ckpt_dir=ck, ckpt_every=100,
                              resume=True, device="cpu", **RUN)[2]
    assert len(second) == 6
    np.testing.assert_allclose(second, jax_full[6:], rtol=RESUME_TOL, atol=RESUME_TOL)


def test_jax_resumes_a_port_checkpoint(tmp_path, port_full):
    ck = str(tmp_path / "ck")
    first = train.train_loop(get_smoke_config(ARCH), steps=6, ckpt_dir=ck, ckpt_every=3,
                             device="cpu", **RUN)[2]
    assert first == port_full[:6]
    second = jax_train.train_loop(jax_smoke(ARCH), steps=12, ckpt_dir=ck, ckpt_every=100,
                                  resume=True, **RUN)[2]
    assert len(second) == 6
    np.testing.assert_allclose(second, port_full[6:], rtol=RESUME_TOL, atol=RESUME_TOL)


def test_port_resume_reproduces_exactly(tmp_path, port_full):
    ck = str(tmp_path / "ck")
    first = train.train_loop(get_smoke_config(ARCH), steps=6, ckpt_dir=ck, ckpt_every=3,
                             device="cpu", **RUN)[2]
    second = train.train_loop(get_smoke_config(ARCH), steps=12, ckpt_dir=ck, ckpt_every=100,
                              resume=True, device="cpu", **RUN)[2]
    assert first + second == port_full


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "recurrentgemma_9b", "whisper_large_v3"])
def test_checkpoint_keys_and_dtypes_are_jax(tmp_path, arch):
    cfg = get_smoke_config(arch)
    tree = numpy_params(cfg, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    jax_store.save_checkpoint(str(tmp_path / "j"), 1, (jparams, jax_adamw_init(jparams)))
    params = load_jax_params(get_model(cfg).init(device="cpu"), tree)
    opt = adamw_init({k: p.detach() for k, p in params.named_parameters()})
    store.save_checkpoint(str(tmp_path / "t"), 1, train.state_tree(params, opt))
    manifests = [store._msgpack.unpackb((tmp_path / d / "step_1" / "manifest.msgpack")
                                        .read_bytes()) for d in ("j", "t")]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert "[1]/.step" in manifests[1]["keys"]
    with np.load(tmp_path / "j" / "step_1" / "arrays.npz") as j, \
            np.load(tmp_path / "t" / "step_1" / "arrays.npz") as t:
        for key in j.files:
            assert j[key].dtype == t[key].dtype and np.array_equal(j[key], t[key]), key
    assert manifests[0]["checksums"] == manifests[1]["checksums"]


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def test_bf16_checkpoint_resumes_exactly_in_the_port(tmp_path):
    cfg = _bf16(get_smoke_config(ARCH))
    full = train.train_loop(cfg, steps=4, device="cpu", **RUN)[2]
    ck = str(tmp_path / "ck")
    first = train.train_loop(cfg, steps=2, ckpt_dir=ck, ckpt_every=1, device="cpu", **RUN)[2]
    with np.load(tmp_path / "ck" / "step_2" / "arrays.npz") as z:
        assert z["[0]/['embed']"].dtype.str == "|V2"  # JAX's bf16 storage
        assert z["[1]/.m/['embed']"].dtype == np.float32 and z["[1]/.step"].dtype == np.int32
    params, opt, second = train.train_loop(cfg, steps=4, ckpt_dir=ck, ckpt_every=100,
                                           resume=True, device="cpu", **RUN)
    assert first + second == full
    assert params.embed.dtype == torch.bfloat16 and int(opt.step) == 4


def test_jax_bf16_checkpoint_loads_bit_for_bit_and_jax_cannot_resume_it(tmp_path):
    p = {"w": jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16),
         "n": jnp.ones((4,), jnp.float32)}
    tree = (p, jax_adamw_init(p))
    jax_store.save_checkpoint(str(tmp_path), 1, tree, extra={"data": {"step": 1}})
    template = ({"w": torch.zeros((3, 4), dtype=torch.bfloat16), "n": torch.zeros(4)},
                adamw_init({"w": torch.zeros((3, 4)), "n": torch.zeros(4)}))
    got, step, extra = store.restore_checkpoint(str(tmp_path), template, device="cpu")
    assert step == 1 and extra == {"data": {"step": 1}}
    assert got[0]["w"].dtype == torch.bfloat16
    want = np.asarray(p["w"]).view(np.int16)
    assert np.array_equal(got[0]["w"].view(torch.int16).numpy(), want)
    assert isinstance(got[1], type(template[1])) and int(got[1].step) == 0
    # the reference behaviour: JAX cannot cast its own |V2 leaves back
    with pytest.raises(ValueError, match="No cast function"):
        jax_store.restore_checkpoint(str(tmp_path), tree)


@pytest.mark.parametrize("arch", ARCH_IDS + ["recurrentgemma_9b:2"])
def test_one_train_step(arch):
    arch, _, layers = arch.partition(":")
    cfg = get_smoke_config(arch)
    if layers:  # under one unit of (rec, rec, attn): the unused unit
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    opt = adamw_init(before)
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=17, global_batch=2).next_batch(device="cpu")
    batch.update(train.step_inputs(cfg, 2, 0, 0, "cpu"))
    opt, loss, gnorm = train.train_step(model, params, opt, batch, peak_lr=3e-4, total_steps=1)
    assert torch.isfinite(loss) and torch.isfinite(gnorm) and int(opt.step) == 1
    for k, p in params.named_parameters():
        unused_zero = bool(layers) and not before[k].any()
        assert unused_zero or not torch.equal(p.detach(), before[k]), k


def test_cli(capsys):
    losses = train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[train] step     0 loss" in out and "[train] first-1 mean loss" in out


def test_train_lm_example_twin(capsys):
    drift = train_lm.main(["minitron_4b", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert drift == 0.0 and "(EXACT)" in out
    assert "--- phase 2: resume from the latest checkpoint ---" in out
