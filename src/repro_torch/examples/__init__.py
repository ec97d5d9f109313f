"""The port's twins of ``examples/``: ``quickstart`` (part 1),
``solve_dimacs`` and ``serve_solver``, each run as
``python -m repro_torch.examples.<name> [--device cpu]``.
"""
