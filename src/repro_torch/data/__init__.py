"""The synthetic token pipeline; the JSON goldens and JAX-written fixtures
beside this file are data the tests and ``chip_smoke.py`` read by path."""

from repro_torch.data.pipeline import SyntheticTokens, make_batch_for

__all__ = ["SyntheticTokens", "make_batch_for"]
