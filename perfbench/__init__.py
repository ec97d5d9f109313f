"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  Everything that belongs to one
configuration, problem, traffic mix, entry, judge or metric sits in a file
of its own that the harness finds by name: ``configs/<config>.json``,
``reference/problems/<problem>.py``, ``traffic/<traffic>.json``,
``drivers/<entry>.py``, ``judges/<judge>.py``, ``metrics/<metric>.py``.
The plain reference under ``reference/`` imports neither the port nor JAX.
"""
