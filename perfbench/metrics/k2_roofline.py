"""k2_roofline: K2 (``chamfer_nn_kernel``, the nearest of the whole
scene) at its launch shape [Q, M], its least time
(``perfbench/counts/bounds.py``) over its mean device time, %."""
from perfbench.metrics._kernel import roofline


def read(record, arg=None):
    return roofline(record, "chamfer_nn_kernel")
