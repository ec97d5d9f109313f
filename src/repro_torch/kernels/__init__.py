"""Hand-written Hopper kernels of the port, one package per TPU kernel family.

Each kernel ships a plain PyTorch version beside it, a wrapper that checks
its inputs and counts its launches (:mod:`repro_torch.kernels.counts`), and
a CUDA source built on first use (:mod:`repro_torch.kernels.build`).
"""
