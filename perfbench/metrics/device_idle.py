"""The device's idle share of the profiled sub-window: 1 - busy / wall,
busy being the union of kernel, copy and memset intervals."""


def read(obs):
    tr = obs["trace"]
    if tr is None or not tr["device"]:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / 1e6 / tr["window_s"])
