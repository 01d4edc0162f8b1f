"""The card's peaks and the contact kernels' least times: the yardstick
that roofline shares are taken against.

A frozen copy of ``fpv4d_torch/utils/cost.py`` at commit cc31d8d
(``PEAK_F32_FLOPS``, ``HBM_BPS``, ``LANE_OPS``, ``bound_ms``,
``k1_bound_ms``, ``k2_bound_ms``), so a change to the program cannot
move the yardstick.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): 67 TFLOP/s in float32 outside the tensor cores (the
program runs float32 with TF32 off), 3.35 TB/s of HBM. ``LANE_OPS`` is
132 SMs x 128 lanes at the 1.98 GHz boost clock, CUDA-core instructions
a second: a card held below that clock (a lower power limit) cannot
reach it, so its shares read low.
"""
from __future__ import annotations

from typing import Tuple

PEAK_F32_FLOPS = 67e12
HBM_BPS = 3.35e12
LANE_OPS = 132 * 128 * 1.98e9


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """The least time of a kernel that moves `nbytes` and issues `ops`
    CUDA-core instructions, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / LANE_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k1_bound_ms(T: int, N: int, P: int) -> Tuple[float, str]:
    """K1 (nearest of each frame's P candidates for its N queries):
    q, cand and valid read once; dist, slot and nearest written once;
    one instruction per (query, candidate) pair."""
    nbytes = (T * N * 3 * 4 + T * P * 3 * 4 + T * P
              + T * N * 4 + T * N * 4 + T * N * 3 * 4)
    return bound_ms(nbytes, float(T * N * P))


def k2_bound_ms(Q: int, M: int, clips: int = 1) -> Tuple[float, str]:
    """K2 (nearest of M cloud points for each of Q queries, per clip):
    x and y read once, dist and idx written once, one instruction per
    (query, point) pair."""
    return bound_ms(clips * (Q * 3 * 4 + M * 3 * 4 + Q * 4 + Q * 4),
                    float(clips * Q * M))
