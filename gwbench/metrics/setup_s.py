"""Set-up seconds: from the process's start to the window's first timed
call (import, the kernels built or loaded, weights and inputs made on the
card, the first steps or the warm-up call)."""


def read(run):
    return run["setup_s"]
