"""Branching problems of the port: the plugin contract
(:mod:`repro_torch.problems.base`), the vertex-cover plugin and its host
reference (:mod:`repro_torch.problems.sequential`)."""
