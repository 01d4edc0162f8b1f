"""Native voxel-grid builder (port of the candidate-table part of
fpv4d/io/native.py: ``build_cand_tables``).

The C++ source is the port's own (csrc/cand_grid.cpp, a copy of the
reference's fpv4d_cand_grid_plan / fpv4d_cand_grid_fill). It is built
with the host C++ compiler at first use (ops/cuda_build.py) into
``fpv4d_torch/_build/`` and loaded with ctypes. Unlike the reference,
which falls back to its NumPy builder when the library cannot be built,
a failed build raises with the compiler's output: ops/nn.py keeps the
NumPy loop as the plain version, reached only by ``use_native=False``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from fpv4d_torch.ops import cuda_build

SRC = cuda_build.CSRC / "cand_grid.cpp"

# native grid builds since the count was last reset (a run sets it to 0
# and reads it back to show which route built its grids)
builds = 0

_plan = None
_fill = None


def _load():
    global _plan, _fill
    if _plan is None:
        f_p = ctypes.POINTER(ctypes.c_float)
        l_p = ctypes.POINTER(ctypes.c_long)
        d_p = ctypes.POINTER(ctypes.c_double)
        i_p = ctypes.POINTER(ctypes.c_int)
        lng, dbl = ctypes.c_long, ctypes.c_double
        _fill, _ = cuda_build.load_function(
            SRC, "cand_grid_fill", [f_p, lng, f_p, l_p, dbl, lng, f_p, i_p],
            restype=lng)
        _plan, _ = cuda_build.load_function(
            SRC, "cand_grid_plan", [f_p, lng, dbl, lng, f_p, l_p, d_p],
            restype=lng)
    return _plan, _fill


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_cand_tables(pts: np.ndarray, h: float, slots_per_cell: int,
                      max_cells: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 Tuple[int, int, int], float]:
    """[N, 3] points -> (cand_pts [cells, K, 3] f32, cand_idx [cells, K]
    i32, origin [3] f32, dims (3 ints), h), the reference's contract.
    Raises ValueError where the reference returns None for its input
    (no points, h <= 0, a non-finite coordinate, an extent beyond
    1e12), and RuntimeError when the library does not build."""
    global builds
    plan, fill = _load()
    pts = np.ascontiguousarray(pts, dtype=np.float32).reshape(-1, 3)
    origin = np.empty(3, np.float32)
    dims = np.empty(3, np.int64)
    h_out = np.empty(1, np.float64)
    num_cells = plan(_ptr(pts, ctypes.c_float), len(pts), float(h),
                     int(max_cells), _ptr(origin, ctypes.c_float),
                     _ptr(dims, ctypes.c_long),
                     _ptr(h_out, ctypes.c_double))
    if num_cells <= 0:
        raise ValueError(
            f"the grid builder rejects these {len(pts)} points with h={h}: "
            "no points, h <= 0, a non-finite coordinate or an extent "
            "beyond 1e12")
    K = int(slots_per_cell)
    cand_pts = np.empty((num_cells, K, 3), np.float32)
    cand_idx = np.empty((num_cells, K), np.int32)
    rc = fill(_ptr(pts, ctypes.c_float), len(pts),
              _ptr(origin, ctypes.c_float), _ptr(dims, ctypes.c_long),
              float(h_out[0]), K, _ptr(cand_pts, ctypes.c_float),
              _ptr(cand_idx, ctypes.c_int))
    if rc != 0:
        raise ValueError(f"the grid builder rejects slots_per_cell={K}")
    builds += 1
    return (cand_pts, cand_idx, origin,
            (int(dims[0]), int(dims[1]), int(dims[2])), float(h_out[0]))
