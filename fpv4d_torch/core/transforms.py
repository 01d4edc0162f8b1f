"""Homogeneous transforms and camera-pose math (port of
fpv4d/core/transforms.py)."""
from __future__ import annotations

import torch

from fpv4d_torch.core.rotations import quat_to_matrot


def to_homo(points: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., N, 4] with trailing 1s."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    return torch.cat([points, ones], dim=-1)


def transform_points(points: torch.Tensor, mat: torch.Tensor
                     ) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., N, 3] -> [..., N, 3] (pad to homo,
    matmul by the transpose; batch dims broadcast)."""
    out = torch.matmul(to_homo(points), mat.transpose(-1, -2))
    return out[..., :3]


def make_translation_mat(t: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 4, 4] identity-rotation transform."""
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    top = torch.cat([eye[:3, :3].expand(t.shape[:-1] + (3, 3)),
                     t[..., :, None]], dim=-1)
    bottom = eye[3:].expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def body2world(camera_ext: torch.Tensor, camera_transl: torch.Tensor,
               scale) -> torch.Tensor:
    """World-from-body per frame: camera_ext @ (I | scale * camera_transl).
    camera_ext [T,4,4], camera_transl [T,3], scale scalar or [T,1]."""
    return torch.matmul(camera_ext,
                        make_translation_mat(camera_transl * scale))


def _rigid(Rt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation and [..., 3] translation of the inverse ->
    [..., 4, 4] (R^T | -R^T t)."""
    ti = -torch.matmul(Rt, t[..., None])[..., 0]
    out = torch.eye(4, dtype=Rt.dtype, device=Rt.device).expand(
        Rt.shape[:-2] + (4, 4)).clone()
    out[..., :3, :3] = Rt
    out[..., :3, 3] = ti
    return out


def invert_rigid(mat: torch.Tensor) -> torch.Tensor:
    """Invert [..., 4, 4] rigid transforms analytically (R^T | -R^T t)."""
    return _rigid(mat[..., :3, :3].transpose(-1, -2), mat[..., :3, 3])


def colmap_pose_to_world_from_cam(qvec: torch.Tensor, tvec: torch.Tensor
                                  ) -> torch.Tensor:
    """COLMAP (qw qx qy qz, t) world-to-camera -> [..., 4, 4]
    world-from-camera, inverted analytically."""
    return _rigid(quat_to_matrot(qvec).transpose(-1, -2), tvec)
