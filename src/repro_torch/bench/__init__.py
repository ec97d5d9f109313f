"""The port's mirrors of ``benchmarks/`` (paper tables, figures and smokes).

Each module runs what its ``benchmarks/`` namesake runs, on the port, and
returns the same rows; :mod:`repro_torch.bench.run` runs them by name.
"""
