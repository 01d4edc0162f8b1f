"""Port parity: the contact NN subset of fpv4d_torch.ops.nn and K1's
plain version (ops/cand_cuda.nn_to_candidates_ref) against
fpv4d.ops.nn and the Pallas kernel in interpret mode, on one voxel
grid built by the JAX package and carried across (the native and NumPy
builders may differ in tie order).

What is exact and what has a tolerance:
  * the NumPy grid builders, cell ids and frame_candidates tables are
    integer/copy logic -> identical;
  * f32 distances: XLA's CPU fusion contracts the three-term distance
    into FMAs, so values differ in the last bit -> rtol 1e-6, and
    winners among exact ties may differ;
  * compact_candidates scores in bf16, and XLA keeps that chain in
    excess precision, so tables differ from the reference's; the test
    holds the property compaction guarantees instead (every distinct
    refresh-time NN is kept while they number <= P_out);
  * the Pallas kernel selects with bf16x3 emulation -> its distances
    match within 1e-3 and never undercut the true minimum."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.ops import nn as JNN
from fpv4d.ops.cand_pallas import cand_nn as pallas_cand_nn
from fpv4d.ops.cand_pallas import pack_candidates
from fpv4d_torch import convert
from fpv4d_torch.ops import cand_cuda as C
from fpv4d_torch.ops import nn as TNN


def _scene(seed=0, n=400):
    rng = np.random.RandomState(seed)
    g = int(np.sqrt(n))
    xs, zs = np.meshgrid(np.linspace(-2, 2, g), np.linspace(-2, 2, g))
    return np.stack([xs.ravel(), -1.0 + 0.05 * rng.randn(g * g),
                     zs.ravel()], 1).astype(np.float32)


@pytest.fixture(scope="module")
def grids():
    jg = JNN.build_voxel_grid(_scene(), h=0.25, slots_per_cell=8)
    tg = convert.voxel_grid_from_numpy(
        np.asarray(jg.cand_pts), np.asarray(jg.cand_idx),
        np.asarray(jg.origin), jg.dims, jg.h)
    return jg, tg


def _queries(T=6, N=40, seed=1):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-1.5, 1.5, (T, 1, 3)).astype(np.float32)
    centers[..., 1] = -0.8
    return (centers + rng.randn(T, N, 3).astype(np.float32) * 0.2)


def test_numpy_grid_builder_identical():
    scene = _scene(seed=2)
    jg = JNN.build_voxel_grid(scene, h=0.25, slots_per_cell=8,
                              use_native=False)
    tg = TNN.build_voxel_grid(scene, h=0.25, slots_per_cell=8,
                              use_native=False)
    assert tg.dims == jg.dims and tg.h == jg.h
    np.testing.assert_array_equal(tg.cand_idx.numpy(),
                                  np.asarray(jg.cand_idx))
    np.testing.assert_array_equal(tg.cand_pts.numpy(),
                                  np.asarray(jg.cand_pts))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))


def test_grid_min_dist(grids):
    jg, tg = grids
    q = _queries()
    q[0, :5] += 30.0                          # far: saturates at BIG
    want = np.asarray(JNN.grid_min_dist(jg, jnp.asarray(q)))
    got = TNN.grid_min_dist(tg, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[0, :5] == TNN.BIG)


def test_grid_min_dist_gradient_matches_reference():
    """Under autodiff (the exact per-step query of
    contact_refresh_steps=0), including queries exactly midway between
    two scene points, where JAX's min splits the gradient evenly."""
    g1 = np.arange(-2.0, 2.01, 0.5, dtype=np.float32)
    xs, zs = np.meshgrid(g1, g1)
    scene = np.stack([xs.ravel(), np.full(xs.size, -1.0, np.float32),
                      zs.ravel()], 1).astype(np.float32)
    jg = JNN.build_voxel_grid(scene, h=0.25, slots_per_cell=16)
    tg = convert.voxel_grid_from_numpy(
        np.asarray(jg.cand_pts), np.asarray(jg.cand_idx),
        np.asarray(jg.origin), jg.dims, jg.h)
    q = _queries(T=3, N=20, seed=5)
    q[0, :3] = [[0.25, -0.8, 0.0], [-1.0, -0.7, 0.75],
                [0.25, -0.9, 1.25]]           # exact two-way ties
    g = np.random.RandomState(4).randn(*q.shape[:-1]).astype(np.float32)
    qt = torch.tensor(q, requires_grad=True)
    d = TNN.grid_min_dist(tg, qt)
    (d * torch.as_tensor(g)).sum().backward()
    jd, vjp = jax.vjp(lambda x: JNN.grid_min_dist(jg, x), jnp.asarray(q))
    (jdq,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(jdq), rtol=1e-5,
                               atol=1e-5)
    # at a tie the gradient pulls toward the midpoint of the two points
    assert qt.grad[0, 0, 0] == 0.0 and qt.grad[0, 1, 2] == 0.0


@pytest.mark.parametrize("budget", [64, 3])
def test_frame_candidates_identical(grids, budget):
    jg, tg = grids
    q = _queries()
    jfc = JNN.frame_candidates(jg, jnp.asarray(q), budget)
    tfc = TNN.frame_candidates(tg, torch.as_tensor(q), budget)
    np.testing.assert_array_equal(tfc.valid.numpy(), np.asarray(jfc.valid))
    np.testing.assert_array_equal(tfc.cand.numpy(), np.asarray(jfc.cand))


def _fc(T=5, N=48, P=96, seed=11, p_valid=0.8):
    rng = np.random.RandomState(seed)
    q = rng.randn(T, N, 3).astype(np.float32)
    cand = rng.randn(T, P, 3).astype(np.float32)
    valid = rng.rand(T, P) < p_valid
    return q, cand, valid


def test_compact_candidates_keeps_distinct_nns():
    q, cand, valid = _fc()
    tfc = TNN.FrameCands(torch.as_tensor(cand), torch.as_tensor(valid))
    qt = torch.as_tensor(q)
    small = TNN.compact_candidates(qt, tfc, 64)
    assert small.cand.shape == (5, 64, 3)
    d_full = C.nn_to_candidates_ref(qt, tfc.cand, tfc.valid).numpy()
    d_comp = C.nn_to_candidates_ref(qt, small.cand, small.valid).numpy()
    np.testing.assert_allclose(d_comp, d_full, rtol=1e-6, atol=1e-6)
    # and the reference's compaction of the same table gives the same
    # distances (its kept set may differ only among non-NN candidates)
    jfc = JNN.compact_candidates(
        jnp.asarray(q), JNN.FrameCands(jnp.asarray(cand),
                                       jnp.asarray(valid)), 64)
    d_ref = np.asarray(JNN.nn_to_candidates(jnp.asarray(q), jfc))
    np.testing.assert_allclose(d_comp, d_ref, rtol=1e-6, atol=1e-6)
    assert TNN.compact_candidates(qt, tfc, 96) is tfc


def test_compact_candidates_lossless_when_valid_fits():
    q, cand, _ = _fc(T=4, N=20, P=64, seed=12)
    valid = np.repeat((np.arange(64) < 24)[None], 4, 0)
    small = TNN.compact_candidates(
        torch.as_tensor(q), TNN.FrameCands(torch.as_tensor(cand),
                                           torch.as_tensor(valid)), 32)
    assert int(small.valid.sum()) == 4 * 24
    q2 = torch.as_tensor(q + 0.3)             # drifted queries
    np.testing.assert_allclose(
        C.nn_to_candidates_ref(q2, small.cand, small.valid).numpy(),
        C.nn_to_candidates_ref(q2, torch.as_tensor(cand),
                               torch.as_tensor(valid)).numpy(), rtol=1e-6)


def test_compact_candidates_stable_on_ties():
    """Score-0 ties are the common case: selection keeps the lower
    slot first, like lax.top_k."""
    q = np.zeros((1, 1, 3), np.float32)
    cand = np.zeros((1, 8, 3), np.float32)    # all tie at score 0
    valid = np.ones((1, 8), bool)
    valid[0, 2] = False
    cand[0, :, 0] = np.arange(8)              # keep them distinguishable
    cand[0, :, 0] = 0.0
    cand[0, :, 1] = np.arange(8) * 1e-3       # bf16 rounds these apart
    out = TNN.compact_candidates(torch.as_tensor(q), TNN.FrameCands(
        torch.as_tensor(cand), torch.as_tensor(valid)), 4)
    jout = JNN.compact_candidates(jnp.asarray(q), JNN.FrameCands(
        jnp.asarray(cand), jnp.asarray(valid)), 4)
    np.testing.assert_array_equal(out.cand.numpy(), np.asarray(jout.cand))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))


def _true_min(q, cand, valid):
    d = ((q[:, :, None, :].astype(np.float64)
          - cand[:, None, :, :]) ** 2).sum(-1)
    d = np.where(valid[:, None, :], d, 1e4)
    return np.minimum(d.min(-1), 1e4)


@pytest.mark.parametrize("seed", [0, 3])
def test_nn_to_candidates_ref_matches_reference(seed):
    q, cand, valid = _fc(T=6, N=40, P=36, seed=seed, p_valid=0.7)
    q *= 2.0
    cand *= 2.0
    cand[:, 1] = cand[:, 0]                   # duplicate candidates
    want = np.asarray(JNN.nn_to_candidates(
        jnp.asarray(q), JNN.FrameCands(jnp.asarray(cand),
                                       jnp.asarray(valid))))
    qt = torch.tensor(q, requires_grad=True)
    got = C.nn_to_candidates_ref(qt, torch.as_tensor(cand),
                                 torch.as_tensor(valid))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    assert np.all(got.detach().numpy() >= _true_min(q, cand, valid) - 1e-5)
    # Pallas kernel (interpret mode), as tests/test_cand_pallas.py runs it
    d_pl = np.asarray(pallas_cand_nn(jnp.asarray(q), pack_candidates(
        jnp.asarray(cand), jnp.asarray(valid)), 4, True))
    np.testing.assert_allclose(got.detach().numpy(), d_pl, atol=1e-3)
    # gradients: robust-contact-shaped downstream
    gj = jax.grad(lambda x: jnp.sum(jnp.sqrt(JNN.nn_to_candidates(
        x, JNN.FrameCands(jnp.asarray(cand), jnp.asarray(valid)))
        + 1e-9)))(jnp.asarray(q))
    torch.sqrt(got + 1e-9).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gj), atol=1e-4,
                               rtol=1e-4)


def test_empty_frame_and_saturation_zero_gradient():
    q, cand, valid = _fc(T=4, N=10, P=16, seed=5)
    valid[2] = False                          # empty frame
    q[0, 0] = [200.0, 0.0, 0.0]               # d^2 > BIG: saturates
    qt = torch.tensor(q, requires_grad=True)
    d = C.nn_to_candidates(qt, torch.as_tensor(cand), torch.as_tensor(valid))
    assert torch.all(d[2] == C.BIG) and d[0, 0] == C.BIG
    d.sum().backward()
    g = qt.grad.numpy()
    assert np.all(g[2] == 0.0) and np.all(g[0, 0] == 0.0)
    assert np.any(g[1] != 0.0)
    jg = jax.grad(lambda x: jnp.sum(JNN.nn_to_candidates(
        x, JNN.FrameCands(jnp.asarray(cand), jnp.asarray(valid)))))(
        jnp.asarray(q))
    np.testing.assert_allclose(g, np.asarray(jg), atol=1e-5)
    # the plain version returns nearest = q where it saturates
    _, _, near = C.cand_nn_plain(torch.as_tensor(q), torch.as_tensor(cand),
                                 torch.as_tensor(valid))
    np.testing.assert_array_equal(near[2].numpy(), q[2])


# -- the fleet: batched grids and folded queries --------------------------------

@pytest.fixture
def numpy_ref_grids(monkeypatch):
    """The reference's batched grid build on its NumPy per-clip path (the
    native code may order ties differently); the port's builder
    arguments for its NumPy path, so both sides take the same route."""
    import functools
    monkeypatch.setattr(JNN, "build_voxel_grid", functools.partial(
        JNN.build_voxel_grid, use_native=False))
    return {"use_native": False}


def _fleet_scenes():
    """Three clips' scenes of different sizes: the second a smaller box."""
    big = _scene(seed=3)
    small = (_scene(seed=4, n=100) * 0.5
             + np.float32([0.3, 0.0, -0.2])).astype(np.float32)
    return [big, small, big[:250]]


def _clip_grid(grid_b, c):
    return TNN.VoxelGrid(cand_pts=grid_b.cand_pts[c],
                         cand_idx=grid_b.cand_idx[c],
                         origin=grid_b.origin[c], dims=grid_b.dims,
                         h=grid_b.h)


@pytest.mark.parametrize("order,h,max_cells", [((0, 1, 2), 0.25, 500_000),
                                               ((1, 0, 2), 0.1, 300)])
def test_build_voxel_grid_batch_identical(numpy_ref_grids, order, h,
                                          max_cells):
    """Shared dims and h, edge-replicated padding; with a cell budget
    that coarsens h for the big clip after the small one was built, every
    clip is rebuilt at the common h."""
    scenes = [_fleet_scenes()[i] for i in order]
    jb = JNN.build_voxel_grid_batch(scenes, h=h, slots_per_cell=8,
                                    max_cells=max_cells)
    tb = TNN.build_voxel_grid_batch(scenes, h=h, slots_per_cell=8,
                                    max_cells=max_cells, **numpy_ref_grids)
    assert tb.dims == jb.dims and tb.h == jb.h
    assert tb.cand_pts.shape == (3, int(np.prod(tb.dims)), 8, 3)
    for name in ("cand_pts", "cand_idx", "origin"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    if max_cells == 300:
        assert tb.h > h


@pytest.mark.parametrize("order,h,max_cells", [((0, 1, 2), 0.25, 500_000),
                                               ((1, 0, 2), 0.1, 300)])
def test_build_voxel_grid_batch_native_identical(order, h, max_cells):
    """Both packages' default route, the native builder: the batched
    tables are identical too (tests/test_torch_native.py holds the
    per-clip builders equal)."""
    from fpv4d.io import native as RN
    assert RN.available()
    scenes = [_fleet_scenes()[i] for i in order]
    jb = JNN.build_voxel_grid_batch(scenes, h=h, slots_per_cell=8,
                                    max_cells=max_cells)
    tb = TNN.build_voxel_grid_batch(scenes, h=h, slots_per_cell=8,
                                    max_cells=max_cells)
    assert tb.dims == jb.dims and tb.h == jb.h
    for name in ("cand_pts", "cand_idx", "origin"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


def _fleet_queries(C=3, T=4, N=24):
    q = np.stack([_queries(T, N, seed=20 + c) for c in range(C)])
    # beyond the small clip's box (inside the big clips' boxes)
    q[1, 0, :4] = [[1.9, -0.8, 1.9], [-1.9, -0.9, -1.9], [1.9, -0.8, -1.9],
                   [0.3, 3.0, -0.2]]
    return q


@pytest.mark.parametrize("budget", [64, 3])
def test_frame_candidates_folded_identical(numpy_ref_grids, budget):
    """Exact against the reference's fold and against each clip's own
    rows of the batched grid."""
    scenes = _fleet_scenes()
    jb = JNN.build_voxel_grid_batch(scenes, h=0.25, slots_per_cell=8)
    tb = TNN.build_voxel_grid_batch(scenes, h=0.25, slots_per_cell=8,
                                    **numpy_ref_grids)
    q = _fleet_queries()
    C, T, N, _ = q.shape
    qf = q.reshape(C * T, N, 3)
    jfc = JNN.frame_candidates_folded(jb, jnp.asarray(qf), C, budget)
    tfc = TNN.frame_candidates_folded(tb, torch.as_tensor(qf), C, budget)
    np.testing.assert_array_equal(tfc.cand.numpy(), np.asarray(jfc.cand))
    np.testing.assert_array_equal(tfc.valid.numpy(), np.asarray(jfc.valid))
    for c in range(C):
        one = TNN.frame_candidates(_clip_grid(tb, c), torch.as_tensor(q[c]),
                                   budget)
        assert torch.equal(tfc.cand[c * T:(c + 1) * T], one.cand)
        assert torch.equal(tfc.valid[c * T:(c + 1) * T], one.valid)
    with pytest.raises(ValueError, match="clips"):
        TNN.frame_candidates_folded(tb, torch.as_tensor(qf[:-1]), C, budget)


def test_grid_min_dist_folded_matches_per_clip(numpy_ref_grids):
    """The folded exact query against each clip's own query (values and
    gradients exact), against the reference's vmapped query (rtol 1e-6,
    FMA contraction), and, beyond the smaller clip's box, against that
    clip's own single grid at the common h: the edge-replicated cells
    give the single-clip clamp's answer (zero padding would give 1e4)."""
    scenes = _fleet_scenes()
    jb = JNN.build_voxel_grid_batch(scenes, h=0.25, slots_per_cell=8)
    tb = TNN.build_voxel_grid_batch(scenes, h=0.25, slots_per_cell=8,
                                    **numpy_ref_grids)
    q = _fleet_queries()
    C, T, N, _ = q.shape
    qt = torch.tensor(q.reshape(C * T, N, 3), requires_grad=True)
    d = TNN.grid_min_dist_folded(tb, qt, C)
    g = torch.as_tensor(np.random.RandomState(6).randn(C * T, N)
                        .astype(np.float32))
    (d * g).sum().backward()
    for c in range(C):
        qc = torch.tensor(q[c], requires_grad=True)
        dc = TNN.grid_min_dist(_clip_grid(tb, c), qc)
        (dc * g[c * T:(c + 1) * T]).sum().backward()
        assert torch.equal(d[c * T:(c + 1) * T].detach(), dc.detach())
        assert torch.equal(qt.grad[c * T:(c + 1) * T], qc.grad)
    jd = jax.vmap(JNN.grid_min_dist, in_axes=(JNN.grid_axes(jb), 0))(
        jb, jnp.asarray(q))
    np.testing.assert_allclose(d.detach().numpy().reshape(C, T, N),
                               np.asarray(jd), rtol=1e-6, atol=1e-7)
    own = TNN.build_voxel_grid(scenes[1], h=tb.h, slots_per_cell=8,
                               **numpy_ref_grids)
    assert own.dims != tb.dims
    d_own = TNN.grid_min_dist(own, torch.as_tensor(q[1]))
    assert torch.equal(d[T:2 * T].detach(), d_own)
    assert bool((d_own[0, :4] < TNN.BIG).all())
