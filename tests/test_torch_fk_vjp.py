"""The port's hand-written FK adjoint (fpv4d_torch.models.fk.
rigid_transform) against plain autograd (rigid_transform_ref) and
against the JAX package's custom VJP (fpv4d.models.fk.rigid_transform),
on numpy-seeded inputs.

Tolerances: the forward is the same function as _fwd_impl, so equal
bit for bit; against JAX, within 1e-6 after dividing by the largest
magnitude (f32 compositions of random, non-orthonormal matrices in
another summation order: the values reach ~1e2). Gradients, after
dividing by the largest magnitude of the reference's, within 2e-5 (the
reference's rule, tests/test_fk_vjp.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.models import fk as jfk
from fpv4d_torch.models import fk as tfk
from fpv4d_torch.models import smplx as tsmplx

CHAIN = (-1, 0, 1, 2, 0, 4, 4)       # a small tree with siblings


def _random_tree(J=20, seed=7):
    rng = np.random.RandomState(seed)
    return (-1,) + tuple(int(rng.randint(0, j)) for j in range(1, J))


TREES = {"smplx": tsmplx.PARENTS, "chain": CHAIN, "random": _random_tree()}


def _rand(parents, B=5, seed=0):
    rng = np.random.RandomState(seed)
    J = len(parents)
    return (rng.randn(B, J, 3, 3).astype(np.float32),
            rng.randn(B, J, 3).astype(np.float32))


def _close(a, b, err_msg="", atol=2e-5):
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                               err_msg=err_msg)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_forward_bitexact_and_equal_to_jax(tree):
    parents = TREES[tree]
    rot, joints = _rand(parents)
    rt, jt = torch.as_tensor(rot), torch.as_tensor(joints)
    p_new, r_new = tfk.rigid_transform(rt, jt, parents)
    p_ref, r_ref = tfk._fwd_impl(rt, jt, parents)
    assert torch.equal(p_new, p_ref) and torch.equal(r_new, r_ref)
    p_j, r_j = jax.jit(lambda a, b: jfk.rigid_transform(a, b, parents))(
        jnp.asarray(rot), jnp.asarray(joints))
    _close(p_new.numpy(), np.asarray(p_j), atol=1e-6)
    _close(r_new.numpy(), np.asarray(r_j), atol=1e-6)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_grad_matches_autograd_and_jax_vjp(tree):
    parents = TREES[tree]
    rot, joints = _rand(parents, seed=1)
    rng = np.random.RandomState(2)
    cp = rng.randn(rot.shape[0], len(parents), 3).astype(np.float32)
    cr = rng.randn(rot.shape[0], len(parents), 4, 4).astype(np.float32)

    def torch_grads(fn):
        a = torch.tensor(rot, requires_grad=True)
        b = torch.tensor(joints, requires_grad=True)
        p, r = fn(a, b, parents)
        ((p * torch.as_tensor(cp)).sum()
         + (r * torch.as_tensor(cr)).sum()).backward()
        return a.grad.numpy(), b.grad.numpy()

    def scalar(a, b):
        p, r = jfk.rigid_transform(a, b, parents)
        return jnp.sum(p * cp) + jnp.sum(r * cr)

    g_new = torch_grads(tfk.rigid_transform)
    g_auto = torch_grads(tfk.rigid_transform_ref)
    g_jax = jax.jit(jax.grad(scalar, argnums=(0, 1)))(jnp.asarray(rot),
                                                      jnp.asarray(joints))
    for name, a, b, c in zip(("rot", "joints"), g_new, g_auto, g_jax):
        _close(a, b, err_msg=f"{name} vs autograd")
        _close(a, np.asarray(c), err_msg=f"{name} vs jax")


def test_a_leaf_without_cotangent():
    """Only the posed joints feed the loss: the transforms' cotangent is
    zero, and the adjoint still equals autograd."""
    rot, joints = _rand(tsmplx.PARENTS, seed=4)
    grads = []
    for fn in (tfk.rigid_transform, tfk.rigid_transform_ref):
        a = torch.tensor(rot, requires_grad=True)
        b = torch.tensor(joints, requires_grad=True)
        fn(a, b, tsmplx.PARENTS)[0].square().sum().backward()
        grads.append((a.grad.numpy(), b.grad.numpy()))
    for x, y in zip(*grads):
        _close(x, y)


@pytest.mark.parametrize("pruned", [False, True])
def test_grad_through_model(monkeypatch, pruned):
    """A whole SMPL-X forward (blendshapes, FK, skinning) with the
    adjoint swapped into fk.rigid_transform_prod against the same model
    on autograd; pruned: the contact vertices' joint support, whose FK
    runs on its own (smaller) tree."""
    from fpv4d_torch.ops import contact
    model = tsmplx.synthetic_model(num_verts=128, seed=0,
                                   sparse_weights=True)
    rng = np.random.RandomState(3)
    T = 4
    args = dict(
        betas=rng.randn(T, 10) * 0.1, global_orient=rng.randn(T, 3) * 0.3,
        body_pose=rng.randn(T, 63) * 0.2, transl=rng.randn(T, 3),
        left_hand_pose=rng.randn(T, 12) * 0.2)
    keys = sorted(args)
    kw = {}
    if pruned:
        segs = contact.synthetic_segments(128, seed=0, coherent=True)
        vids = np.asarray(segs["L_Leg"] + segs["R_Leg"], np.int32)
        sup = model.joint_support(vids)
        assert len(sup[0]) < len(tsmplx.PARENTS)
        kw = dict(vertex_subset=vids, joint_subset=sup[0],
                  pose_joint_subset=sup[1])

    def grads():
        vals = {k: torch.tensor(np.asarray(v, np.float32),
                                requires_grad=True) for k, v in args.items()}
        out = model(**vals, **kw)
        loss = (out["vertices"] ** 2).sum() * 1e-3
        if not pruned:
            loss = loss + out["joints"].abs().sum()
        loss.backward()
        return [vals[k].grad.numpy() for k in keys]

    calls = []

    def adjoint(*a):
        calls.append(a[2])
        return tfk.rigid_transform(*a)

    monkeypatch.setattr(tfk, "rigid_transform_prod", adjoint)
    g_new = grads()
    assert len(calls) == 1       # the model reached FK through the swap
    monkeypatch.setattr(tfk, "rigid_transform_prod", tfk.rigid_transform_ref)
    g_ref = grads()
    for k, a, b in zip(keys, g_new, g_ref):
        _close(a, b, err_msg=k)
