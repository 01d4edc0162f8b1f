"""Carry the JAX package's weights and tables across: each function
takes numpy arrays (``np.asarray`` of the reference's leaves) and
returns the port's object on `device`."""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from fpv4d_torch.models.smplx import SmplxModel
from fpv4d_torch.ops.nn import VoxelGrid


def smplx_from_numpy(arrays: Mapping[str, np.ndarray],
                     flat_hand_mean: bool = False,
                     device="cpu") -> SmplxModel:
    """``SmplxModel._LEAVES`` (models/smplx.py:95) plus ``faces`` (and,
    if present, ``lmk_faces_idx``/``lmk_bary_coords``) -> SmplxModel."""
    kw = {k: np.asarray(arrays[k]) for k in SmplxModel.LEAVES}
    return SmplxModel(**kw, faces=np.asarray(arrays["faces"]),
                      flat_hand_mean=flat_hand_mean,
                      lmk_faces_idx=arrays.get("lmk_faces_idx"),
                      lmk_bary_coords=arrays.get("lmk_bary_coords"),
                      device=device)


def _f32_dict(params: Mapping[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def vposer_from_numpy(params: Mapping[str, np.ndarray],
                      device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's VPoser dict (w1, b1, w2, b2, w3, b3) -> decoder
    params."""
    return _f32_dict(params, device)


def gru_from_numpy(params: Mapping[str, np.ndarray],
                   device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's GRU motion-prior dict (models/motion_gru.py: per
    gate [in, out] weights, the n gate's b_hn apart) -> the port's, key
    for key."""
    return _f32_dict(params, device)


def cvae_params(params: Mapping[str, np.ndarray],
                device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's CVAE dict (models/cvae.py: enc_*/dec_* weights
    [in, out] and biases) -> the port's, key for key."""
    return _f32_dict(params, device)


def voxel_grid_from_numpy(cand_pts: np.ndarray, cand_idx: np.ndarray,
                          origin: np.ndarray, dims: Sequence[int],
                          h: float, device="cpu") -> VoxelGrid:
    """A reference ``VoxelGrid``'s tables -> the port's VoxelGrid (so
    both packages compute on the same tables: the native and NumPy
    builders may differ in tie order)."""
    return VoxelGrid(
        cand_pts=torch.tensor(np.asarray(cand_pts, np.float32),
                              device=device),
        cand_idx=torch.tensor(np.asarray(cand_idx, np.int32),
                              device=device),
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        dims=tuple(int(d) for d in dims), h=float(h))
