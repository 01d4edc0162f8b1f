"""The Gram-form filter of K1 and K2 (csrc/gram_nn.cuh), emulated in
plain PyTorch (fpv4d_torch/ops/gram_nn.py): the exact winner of the
plain versions, and every point tied with it, must pass the filter at
the winner's own exact distance, for every query, whatever the data.
The kernels' results are bit-identical to the plain versions only if
this holds. These tests run on the CPU and never touch the kernels.

The emulation sums the hi/lo products exactly and rounds once; the
kernels' tensor cores truncate, which the margin's accumulation term
(8 times the bound of a truncating 16-product sum) covers."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fpv4d_torch.ops import cand_cuda as C
from fpv4d_torch.ops import chamfer_cuda as K
from fpv4d_torch.ops import cuda_build, gram_nn

KINDS = ["bf16", "tf32"]


def _floor_scene(g=120, seed=0):
    """The standard problem's floor (bench_problem), g x g points."""
    rng = np.random.RandomState(seed)
    xs, zs = np.meshgrid(np.linspace(-5, 5, g), np.linspace(-5, 5, g))
    return np.stack([xs.ravel(), -1.0 + 0.05 * rng.randn(g * g),
                     zs.ravel()], 1).astype(np.float32)


def _legs(n=300, seed=1):
    """Queries in a leg-sized box standing on the floor."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) * [0.6, 1.0, 0.4] + [0.2, -1.05, -0.3]
            ).astype(np.float32)


def _sphere(r=0.37, n=200, seed=2):
    """A query and n points at distance ~r around it in f32, half of
    them moved by one ulp in one coordinate."""
    rng = np.random.RandomState(seed)
    q = np.array([0.3, -0.9, 0.1], np.float32)
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    y = (q + r * u).astype(np.float32)
    y[::2, 0] = np.nextafter(y[::2, 0], np.float32(np.inf))
    return q[None], y


def _ulp_line(r=0.25, k=6):
    """Points at r, r + 1 ulp, ... on both sides of a query: exact ties
    between mirrored points, near-ties one ulp apart."""
    q = np.array([1.5, -0.75, 2.0], np.float32)
    steps = [np.float32(r)]
    for _ in range(k - 1):
        steps.append(np.nextafter(steps[-1], np.float32(1.0)))
    ys = []
    for s in steps[::-1]:
        ys += [q + [s, 0, 0], q - [s, 0, 0], q + [0, 0, s]]
    return q[None], np.asarray(ys, np.float32)


def _k2_case(name):
    y = _floor_scene()
    x = _legs()
    if name == "scale 1":
        return x, y
    if name == "shuffled floor":
        return x, y[np.random.RandomState(3).permutation(len(y))]
    if name == "scale 40, +100":
        return x * 40 + 100, y * 40 + 100
    if name == "far queries":
        return x * 40 + 100, y
    if name == "duplicates":
        return x, np.concatenate([y[:5000], y[:5000], y[:17]])
    if name == "queries equal to points":
        x[:50] = y[1000:1050]
        return x, y
    if name == "near +-1000":
        return x + 1000, np.concatenate([y + 1000, y - 1000])
    if name == "sphere, 1 ulp":
        return _sphere()
    if name == "equidistant, 1 ulp apart":
        return _ulp_line()
    raise KeyError(name)


K2_CASES = ["scale 1", "shuffled floor", "scale 40, +100", "far queries", "duplicates",
            "queries equal to points", "near +-1000", "sphere, 1 ulp",
            "equidistant, 1 ulp apart"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_winner_passes_the_filter(case, kind):
    x, y = _k2_case(case)
    won, passes = K.filter_emulated(torch.as_tensor(x), torch.as_tensor(y),
                                    kind)
    assert bool(won.all()), f"{case}: {int((~won).sum())} winners filtered"
    print(f"[K2 {kind}] {case}: mean passes {float(passes.float().mean())}"
          f", max {int(passes.max())}")


def test_k2_ties_all_pass():
    """Every point tied with the winner passes, not only the first."""
    x, y = _ulp_line()
    d = K.dist_sq_qm(torch.as_tensor(x), torch.as_tensor(y))
    assert int((d == d.min()).sum()) >= 2      # the case has exact ties
    _, passes = K.filter_emulated(torch.as_tensor(x), torch.as_tensor(y))
    assert int(passes[0]) >= int((d == d.min()).sum())


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       scale=st.sampled_from([1e-3, 1.0, 40.0, 1e3]),
       offset=st.sampled_from([0.0, 100.0, -1000.0]),
       n=st.integers(1, 300), m=st.integers(1, 700))
def test_k2_winner_passes_on_random_clouds(seed, scale, offset, n, m):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, 3) * scale + offset).astype(np.float32)
    y = (rng.randn(m, 3) * scale + offset).astype(np.float32)
    y[rng.randint(0, m, size=m // 4)] = y[rng.randint(0, m, size=m // 4)]
    won, _ = K.filter_emulated(torch.as_tensor(x), torch.as_tensor(y))
    assert bool(won.all())


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       scale=st.sampled_from([1e-40, 1e-30, 1e-20, 1e-6, 1.0, 1e6, 1e30]))
def test_threshold_splits_into_three_exact_parts(seed, scale):
    """K2 folds -tau into the product as three parts of the split's type
    whose sum is -tau exactly (gram_nn.split3, csrc/chamfer_nn.cu), but
    for a part that falls below the type's normal range, which the
    margin's absolute floor (1e-20) covers."""
    rng = np.random.RandomState(seed)
    v = torch.as_tensor((rng.randn(500) * scale).astype(np.float32))
    for kind in KINDS:
        parts = gram_nn.split3(v, kind)
        for p in parts:
            assert torch.equal(gram_nn.split(p, kind)[0], p)
        err = (sum(p.double() for p in parts) - v.double()).abs()
        normal = v.abs() >= 2.0 ** -100
        assert bool((err[normal] == 0).all())
        assert bool((err <= gram_nn.ABS).all())


def test_neg_tau_covers_theta_and_marks_rows_without_a_bound():
    th = torch.tensor([-3.0, -1e-8, 0.0, 1e-8, 0.25, 7.0, float("inf")])
    neg = gram_nn.neg_tau(th)
    assert bool((-neg[:-1].double() > th[:-1].double()).all())
    assert float(neg[-1]) == gram_nn.NO_BOUND


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_folded_filter_passes_what_the_margin_passes(case):
    """With tau (neg_tau) folded into the sum, every point with
    F~ <= theta still passes: the folded filter only ever adds re-checks
    to the unfolded one."""
    x, y = (torch.as_tensor(t) for t in _k2_case(case))
    xb = x[:K.BLOCK_QUERIES]
    d = K.dist_sq_qm(xb, y)
    _, n_plain = gram_nn.block_passes(xb, y, d)
    _, n_folded = gram_nn.block_passes(xb, y, d, folded=True)
    assert bool((n_folded >= n_plain).all())


def _k1_tables(T=4, N=300, P=192, seed=3, scale=1.0):
    rng = np.random.RandomState(seed)
    y = _floor_scene(60, seed)
    q = np.stack([_legs(N, seed + t) for t in range(T)]) * scale
    cand = np.stack([y[rng.choice(len(y), P, replace=False)]
                     for _ in range(T)]) * scale
    valid = rng.rand(T, P) > 0.3
    return (torch.as_tensor(q.astype(np.float32)),
            torch.as_tensor(cand.astype(np.float32)), torch.as_tensor(valid))


K1_CASES = ["main P=192", "P=700", "scale 40", "all-invalid frame",
            "one valid slot", "invalid slots at the winner",
            "duplicate candidates", "sphere, 1 ulp"]


def _k1_case(name):
    if name == "P=700":
        return _k1_tables(P=700)
    if name == "scale 40":
        return _k1_tables(scale=40.0)
    q, cand, valid = _k1_tables()
    if name == "all-invalid frame":
        valid[1] = False
    elif name == "one valid slot":
        valid[:] = False
        valid[:, 77] = True
    elif name == "invalid slots at the winner":
        _, slot, _ = C.cand_nn_plain(q, cand, valid)
        valid[0, slot[0].long()] = False       # each winner goes invalid
    elif name == "duplicate candidates":
        cand[:, 1::2] = cand[:, 0::2]
    elif name == "sphere, 1 ulp":
        x, y = _sphere(n=192)
        q = torch.as_tensor(np.repeat(x[None], 2, 0))
        cand = torch.as_tensor(np.repeat(y[None], 2, 0))
        valid = torch.ones(2, 192, dtype=torch.bool)
    return q, cand, valid


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_winner_passes_the_filter(case, kind):
    q, cand, valid = _k1_case(case)
    won, passes = C.filter_emulated(q, cand, valid, kind)
    assert bool(won.all()), f"{case}: {int((~won).sum())} winners filtered"
    print(f"[K1 {kind}] {case}: mean passes {float(passes.float().mean())}"
          f", max {int(passes.max())}")


def test_k1_saturated_rows_are_left_to_the_rescan():
    """A frame with no valid slot has no winner to filter: it counts no
    passes, and the kernel rescans it with the 1e4 rule."""
    q, cand, valid = _k1_tables()
    valid[2] = False
    won, passes = C.filter_emulated(q, cand, valid)
    assert bool(won[2].all()) and int(passes[2].sum()) == 0


def test_bf16_leaves_about_one_recheck_per_query():
    """On the standard problem's floor, a leg's queries re-check about
    one point each (their winner) once the winner is found: bf16 leaves
    no more than TF32 would, at half the mma instructions."""
    x, y = torch.as_tensor(_legs(256)), torch.as_tensor(_floor_scene(317))
    means = {kind: float(K.filter_emulated(x, y, kind)[1].float().mean())
             for kind in KINDS}
    print(f"mean passes per query at 317^2 floor points: {means}")
    assert 1.0 <= means["tf32"] <= means["bf16"] < 1.5


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       scale=st.sampled_from([1e-2, 1.0, 100.0]))
def test_filter_error_is_within_the_margin_terms(seed, scale):
    """|F~ - G| <= e_a 2|a||b| + e_b |b|^2 with G = |b|^2 - 2 a.b taken
    exactly in f64 from the f32 a and b: the model the margin is built
    on, checked for both splits."""
    rng = np.random.RandomState(seed)
    a = torch.as_tensor((rng.randn(40, 3) * scale).astype(np.float32))
    b = torch.as_tensor((rng.randn(60, 3) * scale).astype(np.float32))
    yy = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]) + b[:, 2] * b[:, 2]
    G = (b.double() ** 2).sum(1)[None] - 2 * a.double() @ b.double().T
    na, nb = a.double().norm(dim=1), b.double().norm(dim=1)
    for kind in KINDS:
        e_a, e_b = gram_nn.EPS[kind]
        err = (gram_nn.filter_values(a, b, yy, kind).double() - G).abs()
        bound = e_a * 2 * na[:, None] * nb[None] + e_b * nb[None] ** 2
        assert bool((err <= bound).all())


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       scale=st.sampled_from([1e-3, 1.0, 40.0, 1e3]),
       offset=st.sampled_from([0.0, 100.0, -1000.0]))
def test_seed_bound_covers_every_point(seed, scale, offset):
    """upper_d(F~(m)) >= the exact distance of m, for every pair: a
    row's least filter value bounds its best exact distance."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor((rng.randn(64, 3) * scale + offset)
                        .astype(np.float32))
    y = torch.as_tensor((rng.randn(200, 3) * scale + offset)
                        .astype(np.float32))
    a = x - x[0]
    X, _ = gram_nn.row_bounds(a)
    b, yy = gram_nn.centred_points(y, x[0])
    for kind in KINDS:
        F = gram_nn.filter_values(a, b, yy, kind)
        up = gram_nn.upper_d(F, X[:, None].expand_as(F), kind)
        assert bool((up >= K.dist_sq_qm(x, y)).all())


def test_theta_is_monotone_and_infinite_without_a_distance():
    d = torch.tensor([0.0, 1e-6, 0.01, 1.0, 100.0, float("inf")])
    X = torch.full_like(d, 0.5)
    K_lo = torch.full_like(d, 0.25)
    th = gram_nn.theta(d, X, K_lo)
    assert bool((th[1:] >= th[:-1]).all()) and th[-1] == float("inf")
    assert bool((th[:-1] > d[:-1] - K_lo[:-1]).all())
    assert bool((gram_nn.theta(d[:-1], X[:-1] * 2, K_lo[:-1])
                 >= th[:-1]).all())


def test_library_name_follows_included_headers(tmp_path):
    """Editing a header a source includes renames its library, so a
    stale build is never loaded; editing an unrelated header does not."""
    src = tmp_path / "k.cu"
    hdr = tmp_path / "shared.cuh"
    other = tmp_path / "other.cuh"
    src.write_text('#include "shared.cuh"\nint f() { return g(); }\n')
    hdr.write_text("inline int g() { return 1; }\n")
    other.write_text("inline int h() { return 3; }\n")
    before = cuda_build.library_path(src)
    other.write_text("inline int h() { return 4; }\n")
    assert cuda_build.library_path(src) == before
    hdr.write_text("inline int g() { return 2; }\n")
    after = cuda_build.library_path(src)
    assert after != before and after.name.startswith("libk_")
    assert after.parent == cuda_build.BUILD_DIR


def test_nvcc_searches_the_kernels_directory():
    flags = list(cuda_build.NVCC_FLAGS)
    assert flags[flags.index("-I") + 1] == str(cuda_build.CSRC)
    assert (cuda_build.CSRC / "gram_nn.cuh") in cuda_build._headers(
        cuda_build.CSRC / "chamfer_nn.cu")
