"""Canonical body-parameter layout (port of fpv4d/models/params.py).

    [ 0: 3]  transl               global body translation
    [ 3: 6]  global_orient        axis-angle (6D slots [3:9] in 78-d form)
    [ 6:16]  betas                10 shape coefficients
    [16:48]  body_pose            32-d VPoser latent
    [48:60]  left_hand_pose       12 PCA coefficients
    [60:72]  right_hand_pose      12 PCA coefficients
    [72:75]  camera_translation   egocentric camera pivot
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

SLICES = {
    "transl": (0, 3),
    "global_orient": (3, 6),
    "betas": (6, 16),
    "body_pose": (16, 48),
    "left_hand_pose": (48, 60),
    "right_hand_pose": (60, 72),
    "camera_translation": (72, 75),
}
DIM = 75
DIM_6D = 78
# same slots in the 78-d layout: global_orient widens 3 -> 6, every
# slot after it shifts by +3
SLICES_6D = {
    k: (a if a <= 3 else a + 3, b + 3 if b > 3 else b)
    for k, (a, b) in SLICES.items()
}
VPOSER_SLICE = (16, 48)
VPOSER_SLICE_6D = (19, 51)
# betas + pose latent in the 78-d layout: the smoother's L1 pull toward
# the previous frame reads this slice
SMOOTH_SLICE_6D = (9, 51)


def split(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., 75] -> dict of named slices (views, no copies)."""
    return {k: x[..., a:b] for k, (a, b) in SLICES.items()}


def join(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """dict -> [..., 75] in canonical order."""
    return torch.cat([d[k] for k in SLICES], dim=-1)


def smplx_kwargs(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., 75] -> kwargs for the SMPL-X forward, minus body_pose: the
    32-d VPoser latent is not a joint rotation and must be decoded
    first, and camera_translation places the camera, not the mesh."""
    d = split(x)
    return {k: d[k] for k in ("transl", "global_orient", "betas",
                              "left_hand_pose", "right_hand_pose")}


def split_6d(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., 78] -> dict of named slices (views) in the 6D layout."""
    return {k: x[..., a:b] for k, (a, b) in SLICES_6D.items()}


def from_pkl_dict(param: Dict[str, np.ndarray],
                  with_camera: bool = True) -> np.ndarray:
    """SMPLify-X pkl dict -> [1, 75] (or [1, 72] without the camera)."""
    keys = ["transl", "global_orient", "betas", "body_pose",
            "left_hand_pose", "right_hand_pose"]
    if with_camera:
        keys.append("camera_translation")
    return np.concatenate([np.asarray(param[k], dtype=np.float32)
                           .reshape(1, -1) for k in keys], axis=-1)


def encapsulate_frames(x: np.ndarray, scale: Optional[float] = None,
                       camera_ext: Optional[np.ndarray] = None
                       ) -> List[Dict[str, np.ndarray]]:
    """[T, 75] -> T per-frame dicts for pkl output, each slot [1, k];
    with scale/camera_ext given, each dict also carries the scalar
    'scale' and its frame's [4, 4] 'camera_ext'."""
    x = np.asarray(x)
    out = []
    for t in range(x.shape[0]):
        d = {k: x[t:t + 1, a:b].copy() for k, (a, b) in SLICES.items()}
        if scale is not None:
            d["scale"] = np.float32(scale)
        if camera_ext is not None:
            d["camera_ext"] = np.asarray(camera_ext[t], dtype=np.float32)
        out.append(d)
    return out
