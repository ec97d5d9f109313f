"""The port's synthetic token pipeline against the JAX package's, on the CPU.

* ``next_batch`` equal to JAX's exactly (values and int32) over several
  steps, seeds, vocabularies and shard splits, through a restore;
* ``make_batch_for`` equal to JAX's for a dense, a VLM and an encdec
  config (tokens exactly, the f32 frames and patch embeddings exactly);
* the ports of JAX's ``tests/test_data_pipeline.py``: restart determinism,
  shards, shifted labels, the learnable pattern.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.data.pipeline import make_batch_for as jax_make_batch_for
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens, make_batch_for


@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (512, 17, 8, 0, 1), (151_936, 33, 4, 3, 2), (1000, 9, 8, 5, 4), (65_536, 65, 2, 1, 1)])
def test_batches_equal_jax(vocab, seq, batch, seed, shards):
    ours = SyntheticTokens(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    theirs = JaxTokens(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in range(3):
        for shard in range(shards):
            a = {k: v.numpy() for k, v in ours.next_batch(shard, shards, device="cpu").items()}
            b = {k: np.asarray(v) for k, v in theirs.next_batch(shard, shards).items()}
            ours.step -= 1
            theirs.step -= 1
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert np.array_equal(a[k], b[k])
        ours.step += 1
        theirs.step += 1
    assert ours.state() == theirs.state() == {"step": 3}
    ours.restore({"step": 1})
    theirs.restore({"step": 1})
    assert np.array_equal(ours.next_batch(device="cpu")["tokens"].numpy(),
                          np.asarray(theirs.next_batch()["tokens"]))


def _small(shapes):
    return dataclasses.replace(shapes["train_4k"], seq_len=16, global_batch=2)


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "pixtral_12b", "whisper_large_v3"])
def test_make_batch_for_equals_jax(arch):
    ours = make_batch_for(get_smoke_config(arch), _small(SHAPES), seed=4, device="cpu")
    theirs = jax_make_batch_for(jax_smoke(arch), _small(JAX_SHAPES), seed=4)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert np.array_equal(ours[k].numpy(), np.asarray(v)), k


def test_batches_land_on_the_device_asked():
    b = SyntheticTokens(vocab=64, seq_len=5, global_batch=2).next_batch(device="cpu")
    assert b["tokens"].device.type == "cpu" and b["tokens"].dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SyntheticTokens(vocab=64, seq_len=5, global_batch=2).next_batch()


# -- ports of tests/test_data_pipeline.py ------------------------------------------


def test_restart_determinism():
    a = SyntheticTokens(vocab=1000, seq_len=33, global_batch=8, seed=5)
    a.next_batch(device="cpu")
    b2 = a.next_batch(device="cpu")
    b = SyntheticTokens(vocab=1000, seq_len=33, global_batch=8, seed=5)
    b.restore({"step": 1})  # resume after the first step
    r2 = b.next_batch(device="cpu")
    assert torch.equal(b2["tokens"], r2["tokens"])


def test_shards_partition_global_batch():
    p0 = SyntheticTokens(vocab=512, seq_len=17, global_batch=8, seed=1)
    s0 = p0._batch_np(0, shard=0, num_shards=4)
    s1 = p0._batch_np(0, shard=1, num_shards=4)
    assert s0.shape == (2, 17)
    assert not (s0 == s1).all()
    again = p0._batch_np(0, shard=1, num_shards=4)
    assert (s1 == again).all()


def test_labels_are_shifted_inputs():
    p = SyntheticTokens(vocab=512, seq_len=33, global_batch=2, seed=0)
    b = p.next_batch(device="cpu")
    assert tuple(b["tokens"].shape) == (2, 32)
    assert tuple(b["labels"].shape) == (2, 32)
    full = p._batch_np(0)
    assert np.array_equal(b["tokens"].numpy(), full[:, :-1])
    assert np.array_equal(b["labels"].numpy(), full[:, 1:])


def test_learnable_pattern_exists():
    p = SyntheticTokens(vocab=4096, seq_len=256, global_batch=4, seed=2)
    toks = p.next_batch(device="cpu")["tokens"].numpy()
    for row in toks:
        diffs = (row[1:].astype(int) - row[:-1].astype(int)) % min(4096, 32768)
        vals, counts = np.unique(diffs, return_counts=True)
        assert counts.max() > len(diffs) * 0.4  # dominant delta exists
