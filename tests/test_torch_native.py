"""The port's native voxel-grid builder (fpv4d_torch/io/native.py,
csrc/cand_grid.cpp) against the reference's (fpv4d.io.native.
build_cand_tables, native/fpv4d_native.cpp) and against the port's own
NumPy loop (ops/nn.build_voxel_grid(use_native=False)).

Against the reference's native builder the tables are exactly equal:
the same arithmetic with the same FMA contraction, and the same
std::partial_sort. Against the NumPy loop, which ranks an overflowing
neighbourhood by f64 distances with an unstable argsort, they are equal
up to the order of points tied in distance to the cell's centre: every
cell that does not overflow is exactly equal, and in a cell that does,
the kept points differ only among those at the K-th distance (1e-6
relative, f32 against f64 distances). The origin, the points' minimum
less h, may differ by 1 ulp: the native builders round it once from
f64, NumPy subtracts in f32 (the reference's builders differ alike)."""
import numpy as np
import pytest

from fpv4d.io import native as RN
from fpv4d_torch.io import native as TN
from fpv4d_torch.ops import cuda_build
from fpv4d_torch.ops import nn as TNN


def _scene(kind: str) -> np.ndarray:
    rng = np.random.RandomState(4)
    if kind == "dense":                 # most neighbourhoods overflow
        return (rng.randn(5000, 3) * 2).astype(np.float32)
    if kind == "big_box":               # the cell budget coarsens h
        return (rng.rand(2000, 3) * 40).astype(np.float32)
    if kind == "lattice":               # exact ties at every cell
        g = np.arange(-2, 2, 0.1, dtype=np.float32)
        xs, zs = np.meshgrid(g, g)
        return np.stack([xs.ravel(), np.full(xs.size, -1, np.float32),
                         zs.ravel()], 1)
    g = np.linspace(-3, 3, 60)          # the standard problem's floor
    xs, zs = np.meshgrid(g, g)
    return np.stack([xs.ravel(), -1.0 + 0.05 * rng.randn(xs.size),
                     zs.ravel()], 1).astype(np.float32)


# scene, h, slots per cell, cell budget
_CASES = [("dense", 0.3, 6, 500_000), ("big_box", 0.1, 4, 5000),
          ("lattice", 0.25, 8, 500_000), ("floor", 0.25, 8, 500_000)]


@pytest.fixture(scope="module")
def reference_native():
    if not RN.available():
        pytest.fail("the reference's native library did not build")
    return RN


@pytest.mark.parametrize("kind,h,K,max_cells", _CASES)
def test_tables_equal_the_reference_native_builder(reference_native, kind,
                                                   h, K, max_cells):
    pts = _scene(kind)
    want = reference_native.build_cand_tables(pts, h, K, max_cells)
    got = TN.build_cand_tables(pts, h, K, max_cells)
    assert got[3] == want[3] and got[4] == want[4]
    for a, b, name in zip(got[:3], want[:3], ("cand_pts", "cand_idx",
                                              "origin")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if kind == "big_box":
        assert got[4] > h
    if kind == "dense":
        assert (got[1] >= 0).all(1).sum() > 1000      # overflowing cells


def _center_d2(pts, origin, dims, h, c):
    x, y, z = c // (dims[1] * dims[2]), (c // dims[2]) % dims[1], c % dims[2]
    center = origin.astype(np.float64) + (np.array([x, y, z]) + 0.5) * h
    return lambda idx: ((pts[idx] - center) ** 2).sum(1)


@pytest.mark.parametrize("kind,h,K,max_cells", _CASES)
def test_tables_equal_numpy_up_to_tie_order(kind, h, K, max_cells):
    pts = _scene(kind)
    gn = TNN.build_voxel_grid(pts, h=h, slots_per_cell=K,
                              max_cells=max_cells)
    gp = TNN.build_voxel_grid(pts, h=h, slots_per_cell=K,
                              max_cells=max_cells, use_native=False)
    assert gn.dims == gp.dims and gn.h == gp.h
    # mins - h: rounded once from f64 natively, an f32 difference in NumPy
    np.testing.assert_array_max_ulp(gn.origin.numpy(), gp.origin.numpy(),
                                    maxulp=1)
    idx_n, idx_p = gn.cand_idx.numpy(), gp.cand_idx.numpy()
    pts64 = pts.astype(np.float64)
    differ = np.nonzero((idx_n != idx_p).any(1))[0]
    for c in differ:
        a, b = idx_n[c], idx_p[c]
        assert (a >= 0).all() and (b >= 0).all(), "a cell that fits differs"
        d2 = _center_d2(pts64, gp.origin.numpy(), gp.dims, gp.h, c)
        kth = max(d2(a).max(), d2(b).max())
        for side in (np.setdiff1d(a, b), np.setdiff1d(b, a)):
            np.testing.assert_allclose(d2(side), kth, rtol=1e-6)
        for order in (a, b):
            assert np.all(np.diff(d2(order)) >= -1e-6 * kth)
    kept = idx_n >= 0
    np.testing.assert_array_equal(gn.cand_pts.numpy()[kept],
                                  pts[idx_n[kept]])
    if kind == "lattice":
        assert len(differ) > 0          # exact ties do reorder here


def test_default_route_is_native_and_counted():
    pts = _scene("floor")
    n0 = TN.builds
    g = TNN.build_voxel_grid(pts, h=0.25, slots_per_cell=8)
    assert TN.builds == n0 + 1
    TNN.build_voxel_grid(pts, h=0.25, slots_per_cell=8, use_native=False)
    TNN.build_voxel_grid_batch([pts, pts[:500]], h=0.25, slots_per_cell=8,
                               use_native=False)
    assert TN.builds == n0 + 1
    gb = TNN.build_voxel_grid_batch([pts, pts[:500]], h=0.25,
                                    slots_per_cell=8)
    assert TN.builds == n0 + 3
    assert gb.dims == g.dims
    np.testing.assert_array_equal(gb.cand_idx[0].numpy(), g.cand_idx.numpy())


def test_rejected_points_raise():
    pts = _scene("floor")
    pts[7, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        TNN.build_voxel_grid(pts, h=0.25, slots_per_cell=8)
    with pytest.raises(ValueError):
        TN.build_cand_tables(np.zeros((0, 3), np.float32), 0.25, 8, 1000)


def test_failed_build_raises_with_the_compiler_output(monkeypatch):
    """No quiet fallback to the NumPy loop: a library that does not
    build raises, naming the compiler's output."""
    monkeypatch.setattr(cuda_build, "HOST_FLAGS",
                        cuda_build.HOST_FLAGS + ("-fno-such-option-here",))
    monkeypatch.setattr(TN, "_plan", None)
    monkeypatch.setattr(TN, "_fill", None)
    assert not cuda_build.library_path(TN.SRC).exists()
    with pytest.raises(RuntimeError, match="no-such-option-here"):
        TNN.build_voxel_grid(_scene("floor"), h=0.25, slots_per_cell=8)
    assert not cuda_build.library_path(TN.SRC).exists()


def test_host_library_lands_in_the_build_dir():
    TN.build_cand_tables(_scene("floor"), 0.25, 8, 500_000)
    so = cuda_build.library_path(TN.SRC)
    assert so.exists() and so.parent == cuda_build.BUILD_DIR
    assert so.name.startswith("libcand_grid_")
