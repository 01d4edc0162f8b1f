"""Port parity of fpv4d_torch.ops.sdf against fpv4d.ops.sdf on the same
grids and points.

Tolerances: trilinear interpolation and its analytic gradient are the
same arithmetic in the same order, but XLA's CPU fusion contracts
products into FMAs, so values differ in the last bits: atol 1e-5 on
unit-scale SDF values, 1e-4 on gradients (divided by a cell of ~0.2).
The base-corner clamp and the box clamp are integer logic: exact."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.ops import sdf as JSDF
from fpv4d_torch.ops import sdf as TSDF


def _random_grid(dim=9, seed=0):
    rng = np.random.RandomState(seed)
    vals = rng.randn(dim, dim + 2, dim + 4).astype(np.float32)
    mins = np.array([-2.0, -1.0, -3.0], np.float32)
    maxs = np.array([2.0, 3.0, 1.5], np.float32)
    j = JSDF.SdfGrid(jnp.asarray(vals), jnp.asarray(mins), jnp.asarray(maxs))
    t = TSDF.SdfGrid(torch.tensor(vals), torch.tensor(mins),
                     torch.tensor(maxs))
    return j, t


def _points(n=300, seed=1):
    rng = np.random.RandomState(seed)
    p = rng.uniform(-2.5, 3.5, (4, n // 4, 3)).astype(np.float32)
    p[0, 0] = [2.0, 3.0, 1.5]                 # the box's max corner
    p[0, 1] = [-2.0, -1.0, -3.0]              # its min corner
    p[0, 2] = [50.0, -50.0, 0.0]              # far outside: clamps
    return p


def test_plane_sdf_identical():
    j = JSDF.plane_sdf(y0=-0.7, extent=5.0, dim=17)
    t = TSDF.plane_sdf(y0=-0.7, extent=5.0, dim=17)
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.mins.numpy(), np.asarray(j.mins))
    np.testing.assert_array_equal(t.maxs.numpy(), np.asarray(j.maxs))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_matches_reference(seed):
    jg, tg = _random_grid(seed=seed)
    p = _points(seed=seed + 5)
    s_j, g_j = JSDF.sample(jg, jnp.asarray(p))
    s_t, g_t = TSDF.sample(tg, torch.as_tensor(p))
    assert s_t.shape == p.shape[:-1] and g_t.shape == p.shape
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)


def test_sample_large_grid_clamps_corner_in_integers():
    """At D = 256 a float epsilon below D-1 rounds back to D-1; the
    integer clamp keeps the +1 corners in bounds at the max face."""
    vals = np.arange(256, dtype=np.float32)[:, None, None] \
        * np.ones((256, 4, 4), np.float32)
    mins, maxs = np.zeros(3, np.float32), np.array([1, 1, 1], np.float32)
    tg = TSDF.SdfGrid(torch.tensor(vals), torch.tensor(mins),
                      torch.tensor(maxs))
    jg = JSDF.SdfGrid(jnp.asarray(vals), jnp.asarray(mins),
                      jnp.asarray(maxs))
    p = np.array([[1.0, 1.0, 1.0], [0.999999, 0.5, 0.5]], np.float32)
    s_t, g_t = TSDF.sample(tg, torch.as_tensor(p))
    s_j, g_j = JSDF.sample(jg, jnp.asarray(p))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5)
    assert abs(float(s_t[0]) - 255.0) < 1e-4      # the max face's value


def test_linearize_and_penalty_match_reference():
    jg = JSDF.plane_sdf(y0=0.0, extent=4.0, dim=17)
    tg = TSDF.plane_sdf(y0=0.0, extent=4.0, dim=17)
    rng = np.random.RandomState(3)
    v0 = rng.uniform(-1, 1, (5, 30, 3)).astype(np.float32)
    v = v0 + 0.05 * rng.randn(*v0.shape).astype(np.float32)
    jl = JSDF.linearize(jg, jnp.asarray(v0))
    tl = TSDF.linearize(tg, torch.as_tensor(v0))
    np.testing.assert_allclose(tl.s0.numpy(), np.asarray(jl.s0), atol=1e-5)
    np.testing.assert_allclose(tl.g.numpy(), np.asarray(jl.g), atol=1e-4)
    vt = torch.tensor(v, requires_grad=True)
    pen = TSDF.collision_penalty(vt, tl)
    pen.backward()
    jpen, jgrad = jax.value_and_grad(JSDF.collision_penalty)(
        jnp.asarray(v), jl)
    np.testing.assert_allclose(pen.item(), float(jpen), rtol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-7)
    # exact at the refresh point; the gradient pushes penetrating
    # vertices out of the floor (+y)
    s_exact, _ = TSDF.sample(tg, torch.as_tensor(v0))
    at_v0 = TSDF.collision_penalty(torch.as_tensor(v0), tl)
    np.testing.assert_allclose(float(at_v0),
                               float(torch.relu(-s_exact).mean()),
                               rtol=1e-6)
    assert np.all(vt.grad.numpy()[..., 1] <= 0.0)


def test_prox_loader_matches_reference(tmp_path):
    d = 6
    vals = np.random.RandomState(4).randn(d ** 3).astype(np.float32)
    np.save(tmp_path / "scene_sdf.npy", vals)
    with open(tmp_path / "scene.json", "w") as f:
        json.dump({"min": [-1, -2, -3], "max": [1, 2, 3], "dim": d}, f)
    j = JSDF.load_prox_sdf(str(tmp_path / "scene.json"),
                           str(tmp_path / "scene_sdf.npy"))
    t = TSDF.load_prox_sdf(str(tmp_path / "scene.json"),
                           str(tmp_path / "scene_sdf.npy"))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.mins.numpy(), np.asarray(j.mins))
    np.testing.assert_array_equal(t.maxs.numpy(), np.asarray(j.maxs))
