"""Host launches (kernel and graph launches in the trace's CUDA runtime and
driver calls) per explore round, over the profiled chunk."""


def read(obs):
    tr = obs["trace"]
    rounds = obs["steps_per_round"] * sum(
        c["ran"] for c in obs["chunks"] if c["traced"])
    if tr is None or not rounds or not tr["launches"]:
        return None
    return tr["launches"] / rounds
