"""setup_s: seconds from the process's start to the first timed solve:
imports, the inputs made from the seed, the solver and its grid, the
kernels' build or load, and the warm-up solve (host clock)."""


def read(record, arg=None):
    return record.get("setup_s")
