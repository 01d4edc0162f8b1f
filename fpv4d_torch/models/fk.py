"""Forward kinematics by tree-depth level (port of the production path
of fpv4d/models/fk.py: ``_schedule``, ``_local_transforms``,
``_level_sweep``, ``_fwd_impl``).

All joints at one tree depth compose with their parents in one batched
4x4 matmul, so the SMPL-X tree costs ~11 sequential matmuls instead of
55. ``_fwd_impl`` is the production path, with plain autodiff, as the
reference's ``rigid_transform_prod`` is (fk.py:208-215); the
reference's hand-written adjoint (``rigid_transform``) measured slower
there and is not ported.
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


def _local_transforms(rot_mats: torch.Tensor, rel_joints: torch.Tensor
                      ) -> torch.Tensor:
    """[B,J,3,3] + [B,J,3] -> [B,J,4,4] rigid local transforms."""
    B, J = rel_joints.shape[:2]
    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)
    bottom = torch.zeros(B, J, 1, 4, dtype=rel_joints.dtype,
                         device=rel_joints.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _level_sweep(local: torch.Tensor, parents: Tuple[int, ...]):
    """Compose local transforms down the tree by depth level ->
    world [B,J,4,4]."""
    levels, pos, inv, _ = _schedule(tuple(parents), str(local.device))
    outs = [local[:, levels[0]]]
    for k in range(1, len(levels)):
        wp = outs[-1][:, pos[k]]
        lc = local[:, levels[k]]
        outs.append(torch.matmul(wp, lc))
    return torch.cat(outs, dim=1)[:, inv]


def _fwd_impl(rot_mats: torch.Tensor, joints: torch.Tensor,
              parents: Tuple[int, ...]):
    """rot_mats [B,J,3,3], rest joints [B,J,3] -> (posed joints [B,J,3],
    skinning-relative transforms [B,J,4,4])."""
    _, _, _, par = _schedule(tuple(parents), str(joints.device))
    rel_joints = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]],
                           dim=1)
    world = _level_sweep(_local_transforms(rot_mats, rel_joints), parents)
    posed_joints = world[..., :3, 3]
    correction = torch.einsum("bjpq,bjq->bjp", world[..., :3, :3], joints)
    rel = torch.cat([world[..., :3, :3],
                     (world[..., :3, 3] - correction)[..., None]], dim=-1)
    rel_transforms = torch.cat([rel, world[..., 3:, :]], dim=-2)
    return posed_joints, rel_transforms
