"""Process start to the window's start: imports, the kernel build (only in
a checkout's first run), the instance pool, the first admissions and one
warm chunk."""


def read(obs):
    return obs["setup_s"]
