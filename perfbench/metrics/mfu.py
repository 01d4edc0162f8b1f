"""mfu: the whole solve's share of the card's float32 peak (67 TFLOP/s):
the FLOPs of a solve counted from the benchmark's own plain objective
(``perfbench/counts/flops.py``), times the clips solved in the window,
over the window's wall seconds, %."""
from perfbench.counts.bounds import PEAK_F32_FLOPS


def read(record, arg=None):
    fl = record.get("flops")
    if not fl or not record.get("clips"):
        return None
    rate = sum(fl.values()) * record["clips"] / record["window_s"]
    return 100.0 * rate / PEAK_F32_FLOPS
