"""Wall of one admission inside the window (``_admit_into``: the host's
startup split and the lane's device writes, ended by a synchronize)."""


def read(obs):
    a = obs["admissions"]
    return 1e3 * sum(a) / len(a) if a else None
