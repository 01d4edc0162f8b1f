"""Port parity: fpv4d_torch.ops.losses against fpv4d.ops.losses, values
and gradients on the same numpy-seeded inputs.

Tolerances: elementwise f32 terms reduced by a mean, rtol 1e-6 on the
value (summation order only) and atol 1e-6 on gradients, whose entries
are O(1/size). Inputs include exact zeros, where the L1 terms' gradient
follows the reference's rule d|x|/dx = +1 at 0."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.ops import losses as JL
from fpv4d_torch.ops import losses as TL

_R = np.random.RandomState(0)
T = 12


def _seq(shape, zeros=True):
    x = _R.randn(*shape).astype(np.float32)
    if zeros:
        x[:, :2] = 0.0       # constant columns: exact-zero differences
    return x


WR = np.clip(_R.rand(T).astype(np.float32), 0.0, 1.0)
WR[:3] = [0.5, 0.2, 0.8]

CASES = {
    "rec_l1": (lambda m, a, b: m.rec_l1(a, b, (np.arange(T) % 4 != 1)
                                        .astype(np.float32)),
               [_seq((T, 78)), _seq((T, 78))]),
    "vposer_prior": (lambda m, a: m.vposer_prior(a), [_seq((T, 32))]),
    "second_order_smoothness": (lambda m, a: m.second_order_smoothness(a),
                                [_seq((T, 78))]),
    "first_order_smoothness": (lambda m, a: m.first_order_smoothness(a),
                               [_seq((T, 23, 3))]),
    "robust_contact": (lambda m, a: m.robust_contact(a),
                       [np.abs(_seq((T, 40), False)) * 3]),
    "robust_contact_per_frame": (
        lambda m, a: m.robust_contact_per_frame(a),
        [np.abs(_seq((T, 40), False))]),
    "dct_trajectory": (lambda m, a, c: m.dct_trajectory(a, c, 6),
                       [_seq((T, 23, 3), False),
                        _seq((2, 23, 3, 3), False) * 0.1]),
    "dct_encode": (lambda m, a: m.dct_encode(a, 6, 3),
                   [_seq((T, 23, 3), False)]),
    "foot_skate": (lambda m, a, b: m.foot_skate(a, b, WR),
                   [_seq((T, 9, 3), False), _seq((T, 7, 3), False)]),
    "planted_foot_weight": (lambda m, a, b: m.planted_foot_weight(a, b),
                            [np.abs(_seq((T,), False)),
                             np.abs(_seq((T,), False))]),
    "l1": (lambda m, a, b: m.l1(a, b), [_seq((T, 5)), _seq((T, 5))]),
}


class _TorchNS:
    """The port's module with numpy constants lifted to tensors."""

    def __getattr__(self, name):
        fn = getattr(TL, name)
        return lambda *a: fn(*(torch.as_tensor(x) if isinstance(
            x, np.ndarray) else x for x in a))


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_grad(name):
    fn, args = CASES[name]
    want = np.asarray(fn(JL, *[jnp.asarray(a) for a in args]))
    got = fn(_TorchNS(), *[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    gj = jax.grad(lambda *a: jnp.sum(fn(JL, *a)),
                  argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    fn(_TorchNS(), *xs).sum().backward()
    for g_j, x in zip(gj, xs):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j),
                                   atol=1e-6, rtol=1e-5)


def test_abs_gradient_at_zero_follows_reference():
    """d|x|/dx at 0 is +1 in the reference (JAX's abs rule) and 0 under
    torch.abs: the port's L1 terms follow the reference."""
    x = np.zeros((4, 3), np.float32)
    gj = jax.grad(lambda a: JL.first_order_smoothness(a))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    TL.first_order_smoothness(xt).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    assert np.any(np.asarray(gj) != 0)
