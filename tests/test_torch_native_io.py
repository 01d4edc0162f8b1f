"""The port's native PLY reader, voxel downsample and KD-tree
(fpv4d_torch/io/native.py, csrc/native_io.cpp) against the reference's
(fpv4d.io.native, native/fpv4d_native.cpp) and against the plain
versions (the NumPy downsample, scipy's cKDTree).

The C++ is a copy of the reference's, built with the same compiler and
FMA contraction, so arrays are held equal. Every PLY case of
tests/test_native.py is read by both packages, and the port's decline
counter says which route read each file: the native parser, or (where
it declines) the port's io/ply.py, as the reference falls back to its
Python reader. Against scipy (float64 distances), squared distances
within rtol 1e-6 and indices equal where the runner-up is farther by
more than 1e-4."""
import numpy as np
import pytest

from fpv4d.io import native as RN
from fpv4d.io import ply as rply
from fpv4d_torch.io import native as TN


@pytest.fixture(scope="module")
def cloud():
    return np.random.RandomState(0).randn(4000, 3).astype(np.float32) * 2


@pytest.fixture(scope="module")
def reference_native():
    if not RN.available():
        pytest.fail("the reference's native library did not build")
    return RN


def _hdr(count, fmt="binary_little_endian",
         props=("float x", "float y", "float z")):
    lines = ["ply", f"format {fmt} 1.0", f"element vertex {count}"]
    lines += [f"property {p}" for p in props]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode()


def _binary(path, cloud):
    rply.write_ply(str(path), cloud, binary=True)


def _ascii(path, cloud):
    rply.write_ply(str(path), cloud[:200], binary=False)


def _truncated(path, cloud):
    path.write_bytes(_hdr(100) + np.zeros((10, 3), "<f4").tobytes())


def _absurd_count(path, cloud):
    path.write_bytes(_hdr(10 ** 12) + b"\x00" * 1024)


def _negative_count(path, cloud):
    path.write_bytes(_hdr(-5))


def _garbage(path, cloud):
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(range(256)) * 8)


def _overlong_header_line(path, cloud):
    path.write_bytes(b"ply\nformat binary_little_endian 1.0\n"
                     b"comment " + b"A" * 5000 + b"\n"
                     b"element vertex 2\nproperty float x\n"
                     b"property float y\nproperty float z\nend_header\n"
                     + cloud[:2].astype("<f4").tobytes())


def _big_endian_double(path, cloud):
    path.write_bytes(_hdr(len(cloud), fmt="binary_big_endian",
                          props=("double x", "double y", "double z"))
                     + cloud.astype(">f8").tobytes())


def _ascii_xyz_not_first(path, cloud):
    rows = "".join(f"9 9 9 {x} {y} {z}\n" for x, y, z in cloud[:16])
    path.write_bytes(_hdr(16, fmt="ascii",
                          props=("float nx", "float ny", "float nz",
                                 "float x", "float y", "float z"))
                     + rows.encode())


def _mixed_coord_sizes(path, cloud):
    rec = np.zeros(4, dtype=[("x", "<f8"), ("y", "<f4"), ("z", "<f4")])
    rec["x"], rec["y"], rec["z"] = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    path.write_bytes(_hdr(4, props=("double x", "float y", "float z"))
                     + rec.tobytes())


def _trailing_data(path, cloud):
    path.write_bytes(_hdr(len(cloud)) + cloud.astype("<f4").tobytes()
                     + b"\x00" * 999)


def _element_before_vertex(path, cloud):
    hdr = (b"ply\nformat binary_little_endian 1.0\nelement camera 1\n"
           b"property float cx\nproperty float cy\nproperty float cz\n"
           + f"element vertex {len(cloud)}\n".encode()
           + b"property float x\nproperty float y\nproperty float z\n"
           b"end_header\n")
    path.write_bytes(hdr + np.asarray([[9.0, 9.0, 9.0]], "<f4").tobytes()
                     + cloud.astype("<f4").tobytes())


def _overlong_ascii_row(path, cloud):
    pad = " ".join(["7"] * 2500)
    props = ("float x", "float y", "float z") + tuple(
        f"float j{i}" for i in range(2500))
    path.write_bytes(_hdr(2, fmt="ascii", props=props)
                     + f"1.0 2.0 3.0 {pad}\n4.0 5.0 6.0 {pad}\n".encode())


# writer, the route that reads it ("native" or "declined"), and whether
# the file is bad (both packages raise)
PLY_CASES = {
    "binary": (_binary, "native", False),
    "ascii": (_ascii, "native", False),
    "truncated_binary_body": (_truncated, "declined", True),
    "absurd_vertex_count": (_absurd_count, "declined", True),
    "negative_vertex_count": (_negative_count, "declined", True),
    "non_ply_garbage": (_garbage, "declined", True),
    "overlong_header_line": (_overlong_header_line, "declined", False),
    "big_endian_double": (_big_endian_double, "native", False),
    "ascii_xyz_not_first": (_ascii_xyz_not_first, "native", False),
    "mixed_coord_sizes": (_mixed_coord_sizes, "declined", False),
    "binary_trailing_data": (_trailing_data, "native", False),
    "element_before_vertex": (_element_before_vertex, "declined", False),
    "overlong_ascii_row": (_overlong_ascii_row, "declined", False),
}


@pytest.mark.parametrize("case", sorted(PLY_CASES))
def test_ply_case_against_the_reference(tmp_path, cloud, reference_native,
                                        case):
    write, route, bad = PLY_CASES[case]
    path = tmp_path / f"{case}.ply"
    write(path, cloud)
    TN.ply_declines = 0
    if bad:
        with pytest.raises(Exception):
            reference_native.read_ply_vertices(str(path))
        with pytest.raises(ValueError):
            TN.read_ply_vertices(str(path))
    else:
        want = reference_native.read_ply_vertices(str(path))
        got = TN.read_ply_vertices(str(path))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert TN.ply_declines == (route == "declined")


def test_ply_missing_file_raises(tmp_path):
    TN.ply_declines = 0
    with pytest.raises(FileNotFoundError):
        TN.read_ply_vertices(str(tmp_path / "absent.ply"))
    assert TN.ply_declines == 1


@pytest.mark.parametrize("voxel", [0.5, 0.05, 3.0])
def test_voxel_downsample(cloud, reference_native, voxel):
    got = TN.voxel_downsample(cloud, voxel)
    np.testing.assert_array_equal(
        got, reference_native.voxel_downsample(cloud, voxel))
    assert 0 < len(got) <= len(cloud)
    plain = TN.voxel_downsample(cloud, voxel, use_native=False)

    def rows(a):
        return a[np.lexsort(a.T[::-1])]

    np.testing.assert_array_equal(rows(plain), rows(got))


def test_voxel_downsample_edges():
    sparse = np.eye(3, dtype=np.float32) * 100
    assert TN.voxel_downsample(sparse, 0.5).shape == (3, 3)
    assert TN.voxel_downsample(np.zeros((0, 3)), 0.5).shape == (0, 3)
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError):
            TN.voxel_downsample(sparse, bad)


def test_kdtree_against_the_reference_and_scipy(cloud, reference_native):
    from scipy.spatial import cKDTree
    q = np.random.RandomState(1).randn(500, 3).astype(np.float32) * 2
    tree = TN.KdTree(cloud)
    d, i = tree.query(q)
    assert d.dtype == np.float32 and i.dtype == np.int64
    d_r, i_r = reference_native.KdTree(cloud).query(q)
    np.testing.assert_array_equal(d, d_r)
    np.testing.assert_array_equal(i, i_r)
    dd, ii = cKDTree(cloud).query(q)
    np.testing.assert_allclose(d, dd ** 2, rtol=1e-6)
    both = np.sort(((q[:, None].astype(np.float64) - cloud[None]) ** 2
                    ).sum(-1), axis=1)[:, :2]
    clear = both[:, 1] - both[:, 0] > 1e-4
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(i[clear], ii[clear])
    d_p, i_p = TN.KdTree(cloud, use_native=False).query(q)
    np.testing.assert_array_equal(d_p, (dd ** 2).astype(np.float32))
    np.testing.assert_array_equal(i_p, ii)
    tree.close()
    with pytest.raises(ValueError):
        tree.query(q)


def test_kdtree_exact_hits_and_edges(cloud):
    tree = TN.KdTree(cloud)
    d, i = tree.query(cloud[10:20])
    np.testing.assert_array_equal(d, 0.0)
    np.testing.assert_array_equal(i, np.arange(10, 20))
    one = TN.KdTree(cloud[5:6])
    d1, i1 = one.query(cloud[:3])
    np.testing.assert_array_equal(i1, 0)
    np.testing.assert_allclose(d1, ((cloud[:3] - cloud[5]) ** 2).sum(-1),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        TN.KdTree(np.zeros((0, 3), np.float32))
