"""k1_roofline: K1 (``cand_nn_kernel``, the nearest of each frame's
candidate table) at its launch shape [T, N, P], its least time
(``perfbench/counts/bounds.py``) over its mean device time, %."""
from perfbench.metrics._kernel import roofline


def read(record, arg=None):
    return roofline(record, "cand_nn_kernel")
