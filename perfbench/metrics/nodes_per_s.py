"""Search throughput: branch-and-bound nodes expanded inside the window,
over all lanes, from the solver's own per-worker ``nodes_expanded``
counters, divided by the window's wall."""


def read(obs):
    return obs["nodes"] / obs["window_s"]
