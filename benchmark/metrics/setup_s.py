"""Process start to the first timed call: the weights, the program, the
traffic's pool, the warm-up call (and, in a fresh checkout, the kernels'
build)."""


def read(run):
    return run.setup_s
