"""The port's task codecs and record checks against the JAX package's.

``repro_torch.core.encoding`` holds its own copy of ``repro/core/encoding.py``
(the port imports nothing of ``repro``).  Here the same numpy-made tasks go
through both packages, exactly:

* ``encode``/``decode`` of both codecs give the same uint32 records, byte for
  byte, over n 1-70 and the record schemas of
  ``tests/test_encoding_roundtrip.py`` (the JAX schema stand-in);
* ``payload_checksum``, ``checked_record``, ``verify_record`` and
  ``strip_record`` agree, and one flipped bit anywhere in a checked record
  raises ``PayloadCorruptionError`` in both;
* the ``encoding_bytes`` pins of ``benchmarks/baseline.json`` come out of
  the port's codecs.
"""

import numpy as np
import pytest

from repro.core import encoding as jax_enc
from repro.graphs.generators import erdos_renyi as jax_erdos_renyi
from repro_torch.core import encoding as enc
from repro_torch.graphs.bitgraph import n_words
from repro_torch.graphs.generators import erdos_renyi
from tests._hypothesis_compat import given, settings, strategies as st


class _Problem:
    """A stand-in plugin carrying only the record schema (both packages)."""

    def __init__(self, fields):
        self.record_fields = tuple(fields)


# the schema menu of tests/test_encoding_roundtrip.py
_EXTRA_FIELDS = st.sampled_from(
    [
        (),
        (("score", 1),),
        (("bound", 2), ("tiebreak", 1)),
        (("aux_mask", "W"),),
        (("blob", "n*W"),),
        (("score", 1), ("aux_mask", "W")),
    ]
)


def _words(rng, n, W):
    words = rng.integers(0, 2**32, size=W, dtype=np.uint32)
    if n % 32:
        words[-1] &= np.uint32((1 << (n % 32)) - 1)
    return words


def _task(module, rng, n):
    W = n_words(n)
    return module.Task(mask=_words(rng, n, W), sol_mask=_words(rng, n, W),
                       depth=int(rng.integers(0, n + 1)))


def _encode(codec, task, g):
    return codec.encode(task, g) if codec.name == "basic" else codec.encode(task)


@settings(max_examples=40, deadline=None)
@given(
    st.sampled_from(sorted(enc.CODECS)),
    st.integers(1, 70),
    _EXTRA_FIELDS,
    st.integers(0, 2**31),
)
def test_codecs_encode_and_decode_as_jax(name, n, extra, seed):
    fields = enc.DEFAULT_RECORD_FIELDS + tuple(extra)
    assert fields == jax_enc.DEFAULT_RECORD_FIELDS + tuple(extra)
    ours = enc.make_codec(name, n, problem=_Problem(fields))
    theirs = jax_enc.make_codec(name, n, problem=_Problem(fields))
    assert (ours.record_words, ours.record_bytes, ours.pad_words, ours.native_words) \
        == (theirs.record_words, theirs.record_bytes, theirs.pad_words, theirs.native_words)

    g, jg = erdos_renyi(n, 0.4, seed % 1000), jax_erdos_renyi(n, 0.4, seed % 1000)
    assert (g.adj == jg.adj).all()
    rng = np.random.default_rng(seed)
    task = _task(enc, rng, n)
    jtask = jax_enc.Task(mask=task.mask, sol_mask=task.sol_mask, depth=task.depth)
    rec, jrec = _encode(ours, task, g), _encode(theirs, jtask, jg)
    assert rec.dtype == jrec.dtype == np.uint32
    assert rec.tobytes() == jrec.tobytes()

    back, jback = ours.decode(rec, g), theirs.decode(jrec, jg)
    assert back.key() == jback.key() == task.key()


@pytest.mark.parametrize("seed", range(4))
def test_record_checks_agree_and_catch_every_flipped_bit(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 70))
    codec = enc.make_codec("optimized" if seed % 2 else "basic", n)
    rec = _encode(codec, _task(enc, rng, n), erdos_renyi(n, 0.3, seed))

    assert enc.payload_checksum(rec) == jax_enc.payload_checksum(rec)
    checked = enc.checked_record(rec)
    assert checked.tobytes() == jax_enc.checked_record(rec).tobytes()
    assert enc.verify_record(checked) and jax_enc.verify_record(checked)
    assert enc.strip_record(checked).tobytes() == jax_enc.strip_record(checked).tobytes() \
        == rec.tobytes()

    # one flipped bit anywhere, the checksum word included, is caught
    for bit in rng.choice(32 * checked.size, size=min(64, 32 * checked.size), replace=False):
        bad = checked.copy()
        bad[bit // 32] ^= np.uint32(1 << (bit % 32))
        assert not enc.verify_record(bad) and not jax_enc.verify_record(bad)
        with pytest.raises(enc.PayloadCorruptionError) as ours:
            enc.strip_record(bad)
        with pytest.raises(jax_enc.PayloadCorruptionError) as theirs:
            jax_enc.strip_record(bad)
        assert str(ours.value) == str(theirs.value)
    assert not enc.verify_record(np.zeros(0, np.uint32))


# benchmarks/baseline.json: encoding_bytes (n, optimized, basic, ratio)
_PINS = [(128, 36, 2084, 57.9), (1000, 260, None, 493.3), (4096, 1028, 2098180, 2041.0)]


@pytest.mark.parametrize("n,opt_bytes,basic_bytes,ratio", _PINS)
def test_encoding_bytes_pins(n, opt_bytes, basic_bytes, ratio):
    opt, bas = enc.make_codec("optimized", n), enc.make_codec("basic", n)
    assert opt.record_bytes == opt_bytes
    if basic_bytes is not None:
        assert bas.record_bytes == basic_bytes
    assert round(bas.record_bytes / opt.record_bytes, 1) == ratio
    # and every row of the benchmark equals the JAX package's
    for m in (128, 500, 700, 1000, 4096):
        for name in ("optimized", "basic"):
            assert enc.make_codec(name, m).record_bytes == \
                jax_enc.make_codec(name, m).record_bytes


def test_unknown_codec_and_schema_refuse_as_jax():
    for module in (enc, jax_enc):
        with pytest.raises(ValueError, match="known codecs: basic, optimized"):
            module.make_codec("zstd", 8)
        with pytest.raises(ValueError, match="native"):
            module.OptimizedCodec(8, (("sol", "W"), ("mask", "W"), ("depth", 1)))
