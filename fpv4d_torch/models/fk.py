"""Forward kinematics by tree-depth level, with the reference's
hand-written adjoint (port of fpv4d/models/fk.py).

All joints at one tree depth compose with their parents in one batched
4x4 matmul, so the SMPL-X tree costs ~11 sequential matmuls instead of
55 (``_level_sweep``; ``_fwd_impl`` is the whole forward).

``rigid_transform`` carries the adjoint written by hand as one reverse
sweep over the same depth levels (the reference's custom VJP,
fk.py:148-205), a ``torch.autograd.Function``:

  forward  per level k:   W_k = W_{k-1}[parent] @ L_k
  backward per level k:   Lbar_k  = W_{k-1}[parent]^T @ Wbar_k
                          Wbar_{k-1} += onehot_k @ (Wbar_k @ L_k^T)

The siblings' shares are summed by a static one-hot matmul, in f32 with
TF32 off (the package turns it off), not by ``index_add_``, whose CUDA
atomics would reorder the f32 sum from run to run; the rel-joint
difference's adjoint is a static-matrix matmul too. Its forward is
bit-identical to ``_fwd_impl`` (the same function runs), and its
gradients equal autograd's to f32 rounding.

``rigid_transform_ref`` is plain autograd through ``_fwd_impl``. The
model calls ``rigid_transform_prod`` (models/smplx.py
``batch_rigid_transform``), which is ``rigid_transform_ref``, as in the
reference (fk.py:215); a test or a measurement swaps the adjoint in by
setting this module's attribute.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=None)
def _schedule_np(parents: Tuple[int, ...]):
    """Static per-level schedule: levels[k] = joint ids at depth k
    (sorted); pos[k] = each joint's parent's slot in levels[k-1];
    inv = the permutation from level order back to joint order."""
    parents_arr = np.asarray(parents)
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    by_d = {}
    for j, d in enumerate(depth):
        by_d.setdefault(d, []).append(j)
    levels = [np.asarray(by_d[d]) for d in sorted(by_d)]
    pos = [None] + [np.searchsorted(levels[k - 1], parents_arr[levels[k]])
                    for k in range(1, len(levels))]
    inv = np.argsort(np.concatenate(levels))
    return levels, pos, inv


@lru_cache(maxsize=None)
def _schedule(parents: Tuple[int, ...], device: str):
    """_schedule_np as index tensors on `device` (built once per tree
    and device, so no step uploads indices)."""
    levels, pos, inv = _schedule_np(parents)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    parents_arr = np.asarray(parents)
    return ([as_t(lv) for lv in levels],
            [None] + [as_t(p) for p in pos[1:]],
            as_t(inv), as_t(parents_arr[1:]))


@lru_cache(maxsize=None)
def _adjoint_tables(parents: Tuple[int, ...], device: str):
    """The backward's static f32 matrices on `device`: onehot[k]
    [n_{k-1}, n_k] (rows: parent slots) sums each level's shares into
    its parents; Mt [J, J] is the transpose of rel = M @ joints, M =
    I - P with P[j, parent(j)] = 1 for j >= 1."""
    levels, pos, _ = _schedule_np(parents)
    onehot = [None]
    for k in range(1, len(levels)):
        S = np.zeros((len(levels[k - 1]), len(levels[k])), np.float32)
        S[pos[k], np.arange(len(levels[k]))] = 1.0
        onehot.append(torch.as_tensor(S, device=device))
    J = len(parents)
    Mt = np.eye(J, dtype=np.float32)
    Mt[np.asarray(parents)[1:], np.arange(1, J)] -= 1.0
    return onehot, torch.as_tensor(Mt, device=device)


def _local_transforms(rot_mats: torch.Tensor, rel_joints: torch.Tensor
                      ) -> torch.Tensor:
    """[B,J,3,3] + [B,J,3] -> [B,J,4,4] rigid local transforms."""
    B, J = rel_joints.shape[:2]
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)
    bottom = torch.zeros(B, J, 1, 4, dtype=rel_joints.dtype,
                         device=rel_joints.device)
    bottom[..., 3].fill_(1.0)       # no host scalar tensor: capturable
    return torch.cat([top, bottom], dim=-2)


def _level_sweep(local: torch.Tensor, parents: Tuple[int, ...]):
    """Compose local transforms down the tree by depth level ->
    (world [B,J,4,4], outs: the per-level world blocks, the adjoint's
    residuals)."""
    levels, pos, inv, _ = _schedule(tuple(parents), str(local.device))
    outs = [local[:, levels[0]]]
    for k in range(1, len(levels)):
        wp = outs[-1][:, pos[k]]
        lc = local[:, levels[k]]
        outs.append(torch.matmul(wp, lc))
    return torch.cat(outs, dim=1)[:, inv], outs


def _fwd_res(rot_mats: torch.Tensor, joints: torch.Tensor,
             parents: Tuple[int, ...]):
    """The forward and its residuals: (posed joints [B,J,3],
    skinning-relative transforms [B,J,4,4], (local, outs, world))."""
    _, _, _, par = _schedule(tuple(parents), str(joints.device))
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]],
                           dim=1)
    local = _local_transforms(rot_mats, rel_joints)
    world, outs = _level_sweep(local, parents)
    posed_joints = world[..., :3, 3]
    correction = torch.einsum("bjpq,bjq->bjp", world[..., :3, :3], joints)
    rel = torch.cat([world[..., :3, :3],
                     (world[..., :3, 3] - correction)[..., None]], dim=-1)
    rel_transforms = torch.cat([rel, world[..., 3:, :]], dim=-2)
    return posed_joints, rel_transforms, (local, outs, world)


def _fwd_impl(rot_mats: torch.Tensor, joints: torch.Tensor,
              parents: Tuple[int, ...]):
    """rot_mats [B,J,3,3], rest joints [B,J,3] -> (posed joints [B,J,3],
    skinning-relative transforms [B,J,4,4])."""
    posed, rel, _ = _fwd_res(rot_mats, joints, parents)
    return posed, rel


def rigid_transform_ref(rot_mats: torch.Tensor, joints: torch.Tensor,
                        parents: Tuple[int, ...]):
    """Plain-autograd FK (the oracle of the hand-written adjoint, and the
    production path)."""
    return _fwd_impl(rot_mats, joints, parents)


class _RigidTransform(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rot_mats, joints, parents):
        posed, rel, (local, outs, world) = _fwd_res(rot_mats, joints,
                                                    parents)
        ctx.parents = parents
        ctx.save_for_backward(joints, local, world, *outs)
        return posed, rel

    @staticmethod
    def backward(ctx, g_posed, g_rel):
        joints, local, world, *outs = ctx.saved_tensors
        parents = ctx.parents
        dev = str(joints.device)
        levels, pos, inv, _ = _schedule(parents, dev)
        onehot, Mt = _adjoint_tables(parents, dev)
        B = joints.shape[0]

        # rim: rel = world - e_t (Wrot @ joints), posed = world[:3, 3]
        g_corr = -g_rel[..., :3, 3]                             # [B,J,3]
        gW = g_rel.clone()
        gW[..., :3, 3] += g_posed
        gW[..., :3, :3] += g_corr[..., :, None] * joints[..., None, :]
        g_joints = torch.einsum("bjpq,bjp->bjq", world[..., :3, :3],
                                g_corr)

        # reverse level sweep, the deepest level first
        gW_lvl = [gW[:, lv] for lv in levels]
        g_local_lvl = [None] * len(levels)
        for k in range(len(levels) - 1, 0, -1):
            g = gW_lvl[k]                                      # [B,n,4,4]
            wp = outs[k - 1][:, pos[k]]
            lc = local[:, levels[k]]
            g_local_lvl[k] = torch.matmul(wp.transpose(-1, -2), g)
            t = torch.matmul(g, lc.transpose(-1, -2)).reshape(
                B, len(levels[k]), 16)
            acc = torch.matmul(onehot[k], t).reshape(B, -1, 4, 4)
            gW_lvl[k - 1] = gW_lvl[k - 1] + acc
        g_local_lvl[0] = gW_lvl[0]

        g_local = torch.cat(g_local_lvl, dim=1)[:, inv]        # [B,J,4,4]
        # rel_joints = M @ joints  =>  joints_bar += M^T @ rel_joints_bar
        g_joints = g_joints + torch.matmul(Mt, g_local[..., :3, 3])
        return g_local[..., :3, :3], g_joints, None


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                    parents: Tuple[int, ...]):
    """FK with the hand-written level-sweep adjoint: rot_mats [B,J,3,3],
    rest joints [B,J,3], parents a tuple of parent indices -> (posed
    joints [B,J,3], skinning-relative transforms [B,J,4,4]), the
    smplx package's batch_rigid_transform contract."""
    return _RigidTransform.apply(rot_mats, joints, tuple(parents))


# The implementation the model calls: autograd, as the reference's
# production path is (fk.py:208-215). chip_smoke.py phase 26 times both
# on the card.
rigid_transform_prod = rigid_transform_ref
