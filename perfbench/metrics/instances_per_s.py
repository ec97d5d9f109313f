"""Instances solved to a proven optimum inside the window, divided by the
window's wall: the rate of a service answering a stream."""


def read(obs):
    solved = sum(1 for a in obs["answers"] if a["retired"] and a["exact"])
    return solved / obs["window_s"]
