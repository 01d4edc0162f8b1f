"""Port parity: fpv4d_torch.core (rotations, transforms, DCT basis) and
models.params against the JAX package, values and gradients, on the
same numpy-seeded inputs.

Tolerances: float32 on both sides, the same formulas in the same
order, so values agree to a few ulps (atol 1e-6 on O(1) quantities);
gradients go through transcendental chains (sin/cos/atan2/sqrt) whose
CPU implementations differ in the last bits, so 1e-5."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.core import dct as jdct
from fpv4d.core import rotations as jrot
from fpv4d.core import transforms as jtr
from fpv4d.models import params as jparams
from fpv4d_torch.core import dct as tdct
from fpv4d_torch.core import rotations as trot
from fpv4d_torch.core import transforms as ttr
from fpv4d_torch.models import params as tparams


def _aa(seed=0, n=16):
    rng = np.random.RandomState(seed)
    aa = rng.randn(n, 3).astype(np.float32) * 1.2
    aa[0] = 0.0                                   # zero angle
    aa[1] = np.float32([1e-5, -2e-5, 1e-5])       # small-angle branch
    aa[2] = np.float32([np.pi - 1e-3, 0.0, 0.0])  # near pi
    return aa


def _grad_pair(jfn, tfn, x, seed=1):
    """(jax.grad, torch.autograd) of sum(w * f(x)) for fixed weights w."""
    out = np.asarray(jfn(jnp.asarray(x)))
    w = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (tfn(xt) * torch.as_tensor(w)).sum().backward()
    return np.asarray(gj), xt.grad.numpy()


CODECS = [
    ("aa_to_matrot", jrot.aa_to_matrot, trot.aa_to_matrot, _aa),
    ("aa_to_rot6d", jrot.aa_to_rot6d, trot.aa_to_rot6d, _aa),
    ("matrot_to_aa", jrot.matrot_to_aa, trot.matrot_to_aa,
     lambda s: np.asarray(jrot.aa_to_matrot(jnp.asarray(_aa(s))))),
    ("matrot_to_quat", jrot.matrot_to_quat, trot.matrot_to_quat,
     lambda s: np.asarray(jrot.aa_to_matrot(jnp.asarray(_aa(s))))),
    ("rot6d_to_matrot", jrot.rot6d_to_matrot, trot.rot6d_to_matrot,
     lambda s: np.random.RandomState(s).randn(16, 6).astype(np.float32)),
    ("rot6d_to_aa", jrot.rot6d_to_aa, trot.rot6d_to_aa,
     lambda s: np.random.RandomState(s).randn(16, 6).astype(np.float32)),
]


@pytest.mark.parametrize("name,jfn,tfn,make", CODECS,
                         ids=[c[0] for c in CODECS])
def test_rotation_codec_values_and_grads(name, jfn, tfn, make):
    x = make(0)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    gj, gt = _grad_pair(jfn, tfn, x)
    assert np.all(np.isfinite(gt)), name
    np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=1e-5)


def test_zero_angle_gradients_finite_and_equal():
    """The double-where guards keep gradients finite at exactly zero
    angle, in aa_to_matrot and through the 6D normalizer at a zero
    column (where the reference defines the gradient as finite too)."""
    aa = np.zeros((2, 3), np.float32)
    gj, gt = _grad_pair(jrot.aa_to_matrot, trot.aa_to_matrot, aa)
    assert np.all(np.isfinite(gt))
    np.testing.assert_allclose(gt, gj, atol=1e-6)
    r6 = np.zeros((2, 6), np.float32)
    r6[:, 0] = 1.0                               # second column zero
    gj, gt = _grad_pair(jrot.rot6d_to_matrot, trot.rot6d_to_matrot, r6)
    assert np.all(np.isfinite(gt))
    np.testing.assert_allclose(gt, gj, atol=1e-6)


def test_params_lifts_and_split_6d():
    rng = np.random.RandomState(3)
    x75 = rng.randn(7, 75).astype(np.float32) * 0.5
    x75[0, 3:6] = 0.0
    want6 = np.asarray(jrot.params_to_6d(jnp.asarray(x75)))
    got6 = trot.params_to_6d(torch.as_tensor(x75)).numpy()
    np.testing.assert_allclose(got6, want6, atol=1e-6)
    np.testing.assert_allclose(
        trot.params_to_3d(torch.as_tensor(want6)).numpy(),
        np.asarray(jrot.params_to_3d(jnp.asarray(want6))), atol=1e-5)
    gj, gt = _grad_pair(jrot.params_to_6d, trot.params_to_6d, x75)
    np.testing.assert_allclose(gt, gj, atol=1e-5)
    assert tparams.SLICES_6D == jparams.SLICES_6D
    assert tparams.VPOSER_SLICE == jparams.VPOSER_SLICE
    assert tparams.VPOSER_SLICE_6D == jparams.VPOSER_SLICE_6D
    dj = jparams.split_6d(jnp.asarray(want6))
    dt = tparams.split_6d(torch.as_tensor(want6))
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(dt[k].numpy(), np.asarray(dj[k]))


def test_transforms_values_and_grads():
    rng = np.random.RandomState(4)
    T = 5
    cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    cam[:, :3, :3] = np.asarray(jrot.aa_to_matrot(
        jnp.asarray(rng.randn(T, 3).astype(np.float32))))
    cam[:, :3, 3] = rng.randn(T, 3)
    ct = rng.randn(T, 3).astype(np.float32)
    pts = rng.randn(T, 11, 3).astype(np.float32)
    b2w_j = np.asarray(jtr.body2world(jnp.asarray(cam), jnp.asarray(ct),
                                      1.7))
    b2w_t = ttr.body2world(torch.as_tensor(cam), torch.as_tensor(ct), 1.7)
    np.testing.assert_allclose(b2w_t.numpy(), b2w_j, atol=1e-6)
    np.testing.assert_allclose(
        ttr.transform_points(torch.as_tensor(pts), b2w_t).numpy(),
        np.asarray(jtr.transform_points(jnp.asarray(pts),
                                        jnp.asarray(b2w_j))), atol=1e-5)
    np.testing.assert_array_equal(
        ttr.make_translation_mat(torch.as_tensor(ct)).numpy(),
        np.asarray(jtr.make_translation_mat(jnp.asarray(ct))))
    gj, gt = _grad_pair(
        lambda p: jtr.transform_points(p, jnp.asarray(b2w_j)),
        lambda p: ttr.transform_points(p, torch.as_tensor(b2w_j)), pts)
    np.testing.assert_allclose(gt, gj, atol=1e-5)


@pytest.mark.parametrize("n,k", [(60, 5), (12, 3)])
def test_dct_basis_identical(n, k):
    np.testing.assert_array_equal(tdct.dct_basis(n, k).numpy(),
                                  np.asarray(jdct.dct_basis(n, k)))
