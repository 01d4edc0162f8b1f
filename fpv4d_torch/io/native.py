"""The port's native host data plane (port of fpv4d/io/native.py): the
voxel-grid builder (``build_cand_tables``), the PLY vertex reader
(``read_ply_vertices``), the voxel downsample (``voxel_downsample``)
and a KD-tree nearest-neighbour search (``KdTree``).

The C++ sources are the port's own (csrc/cand_grid.cpp, a copy of the
reference's fpv4d_cand_grid_plan / fpv4d_cand_grid_fill; csrc/
native_io.cpp, a copy of its PLY parser, downsample and KD-tree). Each
is built with the host C++ compiler at first use (ops/cuda_build.py)
into ``fpv4d_torch/_build/`` and loaded with ctypes. Unlike the
reference, which falls back to Python when its library cannot be
built, a failed build raises with the compiler's output; the plain
versions (ops/nn.py's NumPy grid loop, the NumPy downsample, a
``scipy.spatial.cKDTree`` query) are reached only by
``use_native=False``. A PLY file that the native parser declines
(mixed coordinate sizes, an element before ``vertex``, an over-long
ASCII row, a bad header) is read by the port's io/ply.py, as the
reference reads it with its Python reader; ``ply_declines`` counts
those files.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from fpv4d_torch.ops import cuda_build

SRC = cuda_build.CSRC / "cand_grid.cpp"
IO_SRC = cuda_build.CSRC / "native_io.cpp"

# native grid builds since the count was last reset (a run sets it to 0
# and reads it back to show which route built its grids)
builds = 0
# PLY files the native parser declined since the count was last reset
# (each then read by io/ply.py)
ply_declines = 0

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


_io = {}


def _io_fn(name: str):
    """The entry point `name` of csrc/native_io.cpp's library, declared,
    building the library first if it is missing."""
    if not _io:
        f_p = ctypes.POINTER(ctypes.c_float)
        l_p = ctypes.POINTER(ctypes.c_long)
        lng, vp, cp = ctypes.c_long, ctypes.c_void_p, ctypes.c_char_p
        for fn, args, res in (
                ("ply_vertex_count", [cp], lng),
                ("ply_read_vertices", [cp, f_p, lng], lng),
                ("voxel_downsample", [f_p, lng, ctypes.c_float, f_p], lng),
                ("kdtree_build", [f_p, lng], vp),
                ("kdtree_free", [vp], None),
                ("kdtree_query", [vp, f_p, lng, f_p, l_p], None)):
            _io[fn], _ = cuda_build.load_function(IO_SRC, fn, args,
                                                  restype=res)
    return _io[name]


def read_ply_vertices(path: str) -> np.ndarray:
    """[N, 3] float32 vertices of a PLY file, by the native parser; a
    file it declines is read by io/ply.py (and counted in
    ``ply_declines``), which raises ValueError on a bad file."""
    global ply_declines
    p = str(path).encode()
    n = _io_fn("ply_vertex_count")(p)
    if n >= 0:
        out = np.empty((n, 3), np.float32)
        if _io_fn("ply_read_vertices")(p, _ptr(out, ctypes.c_float), n) == n:
            return out
    ply_declines += 1
    from fpv4d_torch.io.ply import read_ply
    return read_ply(str(path))[0]


def voxel_downsample(pts: np.ndarray, voxel: float,
                     use_native: bool = True) -> np.ndarray:
    """The mean of the points in each occupied cell of a `voxel`-sized
    grid: [N, 3] -> [M, 3] float32. Natively, cells come in the order of
    their first point; the plain NumPy version (use_native=False) sums
    the same cells in float64 and returns them in np.unique's order."""
    pts = np.ascontiguousarray(pts, dtype=np.float32).reshape(-1, 3)
    if not voxel > 0:
        raise ValueError(f"voxel={voxel}: the voxel size must be > 0")
    if len(pts) == 0:
        return np.empty((0, 3), np.float32)
    if use_native:
        out = np.empty_like(pts)
        m = _io_fn("voxel_downsample")(_ptr(pts, ctypes.c_float), len(pts),
                                       float(voxel),
                                       _ptr(out, ctypes.c_float))
        return out[:m].copy()
    cells = np.floor(pts / voxel).astype(np.int64)
    _, inverse, counts = np.unique(cells, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((len(counts), 3), dtype=np.float64)
    np.add.at(sums, inverse.reshape(-1), pts)
    return (sums / counts[:, None]).astype(np.float32)


class KdTree:
    """Nearest-neighbour queries against a fixed [N, 3] cloud: the
    native median-split tree (16-point leaves), or a scipy cKDTree with
    use_native=False. ``close()`` frees the native tree."""

    def __init__(self, pts: np.ndarray, use_native: bool = True):
        self._pts = np.ascontiguousarray(pts, dtype=np.float32).reshape(
            -1, 3)
        if len(self._pts) == 0:
            raise ValueError("KdTree needs at least one point")
        self._handle: Optional[int] = None
        self._scipy = None
        if use_native:
            self._handle = _io_fn("kdtree_build")(
                _ptr(self._pts, ctypes.c_float), len(self._pts))
        else:
            from scipy.spatial import cKDTree
            self._scipy = cKDTree(self._pts)

    def query(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[Q, 3] -> (squared distance [Q] f32, index [Q] int64)."""
        q = np.ascontiguousarray(q, dtype=np.float32).reshape(-1, 3)
        if self._scipy is not None:
            dist, idx = self._scipy.query(q)
            return (dist ** 2).astype(np.float32), idx.astype(np.int64)
        if self._handle is None:
            raise ValueError("the KdTree was closed")
        d = np.empty(len(q), np.float32)
        i = np.empty(len(q), np.int64)
        _io_fn("kdtree_query")(ctypes.c_void_p(self._handle),
                               _ptr(q, ctypes.c_float), len(q),
                               _ptr(d, ctypes.c_float),
                               _ptr(i, ctypes.c_long))
        return d, i

    def close(self) -> None:
        if self._handle is not None:
            _io_fn("kdtree_free")(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):  # interpreter teardown
            pass
