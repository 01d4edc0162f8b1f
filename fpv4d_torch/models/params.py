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

from typing import Dict

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


def split_6d(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., 78] -> dict of named slices (views) in the 6D layout."""
    return {k: x[..., a:b] for k, (a, b) in SLICES_6D.items()}
