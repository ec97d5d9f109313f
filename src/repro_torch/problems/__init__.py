"""Branching problems of the port: the plugin contract
(:mod:`repro_torch.problems.base`), the vertex-cover, max-clique and MIS
plugins, their registry and their host references
(:mod:`repro_torch.problems.sequential`)."""
