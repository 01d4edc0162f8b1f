"""The port's L-BFGS (fpv4d_torch/solve/lbfgs.py) against optax 0.2.6 on
deterministic problems in float64, apart from any model: the chained
Rosenbrock function and an ill-conditioned quadratic, each from several
starting points batched as lanes.

  * zoom: ``optax.lbfgs(memory_size=8)`` with its defaults, as the
    keypoint fit's joint L-BFGS runs it (one lane = one clip; several
    lanes = the reference's vmap over clips);
  * backtracking: ``optax.lbfgs(memory_size=8, linesearch=optax.
    scale_by_backtracking_linesearch(max_backtracking_steps=15,
    store_grad=True))`` vmapped over lanes, as the per-frame L-BFGS runs.

The reference runs under the ``jax.enable_x64(True)`` context manager,
never a global flag. Iterates and values must match to 1e-8: in float64
the two implementations round differently only in the last bits, so
every branch of the line searches goes the same way (an f32 trajectory
of a branchy line search cannot be held step by step; the keypoint
fit's tests hold its results instead)."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from fpv4d_torch.solve import lbfgs as L

N_ITER = 40


def _rosen_np(x, xp):
    return xp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                  + (1.0 - x[..., :-1]) ** 2, axis=-1)


def _quad_diag(d):
    return np.logspace(0, 3, d)


PROBLEMS = {
    "rosenbrock": (
        lambda x: _rosen_np(x, jnp),
        lambda x: torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                            + (1.0 - x[..., :-1]) ** 2, dim=-1),
        np.array([[-1.2, 1.0, -0.5, 0.8, 1.5, -1.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [2.0, -1.5, 1.0, 0.3, -0.7, 1.2]])),
    "ill_conditioned_quadratic": (
        lambda x: 0.5 * jnp.sum(jnp.asarray(_quad_diag(x.shape[-1]))
                                * (x - 1.0) ** 2, axis=-1),
        lambda x: 0.5 * torch.sum(torch.as_tensor(_quad_diag(x.shape[-1]))
                                  * (x - 1.0) ** 2, dim=-1),
        np.array([[3.0, -2.0, 0.5, 1.5, -1.0, 2.5, 0.1, -0.3],
                  [-1.0, 4.0, 2.0, -3.0, 0.0, 1.0, 2.0, 0.5]])),
}


def _optax_lanes(opt, f, x0, n):
    """Iterates [n, B, D] and values [n, B] of the optax loop (value and
    gradient from the state), vmapped over lanes."""
    vg = optax.value_and_grad_from_state(f)

    def run(x):
        def step(carry, _):
            p, st = carry
            v, g = vg(p, state=st)
            upd, st = opt.update(g, st, p, value=v, grad=g, value_fn=f)
            p = optax.apply_updates(p, upd)
            return (p, st), (p, v)

        _, (ps, vs) = jax.lax.scan(step, (x, opt.init(x)), None, length=n)
        return ps, vs

    ps, vs = jax.jit(jax.vmap(run))(x0)
    return np.asarray(ps).transpose(1, 0, 2), np.asarray(vs).T


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
def test_lbfgs_iterates_match_optax_in_float64(problem, linesearch):
    jf, tf, x0 = PROBLEMS[problem]
    if linesearch == "zoom":
        opt = optax.lbfgs(memory_size=8)
    else:
        opt = optax.lbfgs(memory_size=8,
                          linesearch=optax.scale_by_backtracking_linesearch(
                              max_backtracking_steps=15, store_grad=True))
    with jax.enable_x64(True):
        ref_x, ref_v = _optax_lanes(opt, jf, jnp.asarray(x0, jnp.float64),
                                    N_ITER)
    assert ref_x.dtype == np.float64
    # every lane moved, and some lane is still moving at the last step
    assert np.all(np.abs(ref_x[-1] - x0).max(-1) > 1e-2)
    assert np.any(np.abs(ref_x[-1] - ref_x[-2]).max(-1) > 1e-6)
    x0_t = torch.tensor(x0, dtype=torch.float64)
    for k in range(1, N_ITER + 1):
        x, hist = L.minimize(tf, x0_t, k, memory_size=8,
                             linesearch=linesearch)
        np.testing.assert_allclose(x.numpy(), ref_x[k - 1], rtol=1e-8,
                                   atol=1e-8, err_msg=f"iterate {k}")
    np.testing.assert_allclose(hist.numpy(), ref_v, rtol=1e-8, atol=1e-8)


def test_lanes_are_independent():
    """A lane's trajectory does not depend on the other lanes (each has
    its own memory, line search and step size)."""
    _, tf, x0 = PROBLEMS["rosenbrock"]
    x0_t = torch.tensor(x0, dtype=torch.float64)
    for ls in ("zoom", "backtracking"):
        x_all, h_all = L.minimize(tf, x0_t, 10, linesearch=ls)
        for b in range(x0.shape[0]):
            x_b, h_b = L.minimize(tf, x0_t[b:b + 1], 10, linesearch=ls)
            assert torch.equal(x_all[b:b + 1], x_b)
            assert torch.equal(h_all[:, b:b + 1], h_b)


def test_first_step_is_capped_to_the_unit_ball():
    """With memory empty the direction is the gradient scaled by
    min(1, 1/|g|): the first trial point lies within distance 1."""
    _, tf, x0 = PROBLEMS["ill_conditioned_quadratic"]
    x = torch.tensor(x0, dtype=torch.float64)
    v, g = L.value_and_grad(tf, x)
    mem = L._Memory(x, 8)
    d = mem.direction(x, g)
    scale = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0)
    torch.testing.assert_close(d, g * scale[:, None], rtol=0, atol=0)
    assert bool((torch.linalg.vector_norm(d, dim=-1) <= 1.0 + 1e-12).all())
