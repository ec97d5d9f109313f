"""PyTorch/CUDA port of the semi-centralized branching solver.

A second package beside the JAX reference ``repro``, with the same layout
(``graphs/``, ``problems/``, ``core/``, ``kernels/``, ``api/``, ``launch/``).
It imports torch and numpy only — nothing of JAX and nothing of ``repro`` —
and runs on a CUDA device unless the caller asks for the CPU.  The TPU's
Pallas kernels become hand-written CUDA kernels for Hopper
(``kernels/*/csrc/``), built with nvcc on first use.

Entry points: :class:`repro_torch.api.SolverSession` and
``python -m repro_torch.launch.solve``.
"""
