"""GRU motion prior: next-pose prediction in VPoser latent space (port of
fpv4d/models/motion_gru.py).

A GRU encoder over the previous 32-d pose latent and a GRU decoder that
emits the predicted next latent, with a noise input of EPS_DIM:
``forward_seq(pose_prev, seq_length, h_enc, h_dec) -> (pose_pred,
h_enc', h_dec')``. Parameters are a plain dict of tensors with the
reference's keys (weights stored [in, out], one matrix per gate).

The gates are plain matmuls in torch's GRU convention, with the n
gate's hidden bias kept apart: n = tanh(W_in x + b_in + r * (W_hn h +
b_hn)). ``random_params`` draws the reference's RandomState sequence,
so both packages hold the same stand-in weights;
``params_from_torch_state_dict`` reads an nn.GRU-style checkpoint.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

IN_DIM = 32
H_ENC = 512
H_DEC = 512
EPS_DIM = 32

Params = Dict[str, torch.Tensor]


def _gru_arrays(rng, in_dim: int, h_dim: int, prefix: str
                ) -> Dict[str, np.ndarray]:
    out = {}
    s = 1.0 / np.sqrt(h_dim)
    for gate in ("r", "z", "n"):
        out[f"{prefix}_w_i{gate}"] = rng.uniform(-s, s, (in_dim, h_dim))
        out[f"{prefix}_w_h{gate}"] = rng.uniform(-s, s, (h_dim, h_dim))
        out[f"{prefix}_b_{gate}"] = np.zeros(h_dim)
    out[f"{prefix}_b_hn"] = np.zeros(h_dim)
    return out


def random_params(seed: int = 0, device="cpu") -> Params:
    """Deterministic stand-in weights (the reference's checkpoint is not
    distributed): the reference's draws, in its order."""
    rng = np.random.RandomState(seed)
    p = {}
    p.update(_gru_arrays(rng, IN_DIM, H_ENC, "enc"))
    p.update(_gru_arrays(rng, H_ENC + EPS_DIM, H_DEC, "dec"))
    s = 1.0 / np.sqrt(H_DEC)
    p["out_w"] = rng.uniform(-s, s, (H_DEC, IN_DIM))
    p["out_b"] = np.zeros(IN_DIM)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in p.items()}


def _gru_cell(p: Params, prefix: str, x: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    r = torch.sigmoid(x @ p[f"{prefix}_w_ir"] + h @ p[f"{prefix}_w_hr"]
                      + p[f"{prefix}_b_r"])
    z = torch.sigmoid(x @ p[f"{prefix}_w_iz"] + h @ p[f"{prefix}_w_hz"]
                      + p[f"{prefix}_b_z"])
    # the reset gate multiplies the whole hidden contribution, its bias
    # included (torch's convention)
    n = torch.tanh(x @ p[f"{prefix}_w_in"] + p[f"{prefix}_b_n"]
                   + r * (h @ p[f"{prefix}_w_hn"] + p[f"{prefix}_b_hn"]))
    return (1.0 - z) * n + z * h


def forward_seq(params: Params, pose_prev: torch.Tensor,
                seq_length: int = 1, h_enc: Optional[torch.Tensor] = None,
                h_dec: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Predict the next seq_length pose latents.

    pose_prev [B, 32] (or [B, 32, 1]), h_enc/h_dec [B, H] (or [B, 1, H]).
    Returns (pose_pred [B, 32, seq_length], h_enc', h_dec'); the
    smoother reads pose_pred[:, :, -1]."""
    if pose_prev.dim() == 3:
        pose_prev = pose_prev[..., 0]
    B = pose_prev.shape[0]
    kw = dict(dtype=pose_prev.dtype, device=pose_prev.device)
    squeeze_back = False
    if h_enc is None:
        h_enc = torch.zeros((B, H_ENC), **kw)
    elif h_enc.dim() == 3:
        h_enc, squeeze_back = h_enc[:, 0], True
    if h_dec is None:
        h_dec = torch.zeros((B, H_DEC), **kw)
    elif h_dec.dim() == 3:
        h_dec = h_dec[:, 0]
    if noise is None:
        noise = torch.zeros((B, seq_length, EPS_DIM), **kw)

    h_enc = _gru_cell(params, "enc", pose_prev, h_enc)
    poses = []
    for s in range(seq_length):
        h_dec = _gru_cell(params, "dec",
                          torch.cat([h_enc, noise[:, s]], dim=-1), h_dec)
        poses.append(h_dec @ params["out_w"] + params["out_b"])
    pose_pred = torch.stack(poses, dim=-1)                # [B, 32, S]
    if squeeze_back:
        h_enc, h_dec = h_enc[:, None], h_dec[:, None]
    return pose_pred, h_enc, h_dec


def params_from_torch_state_dict(sd, device="cpu") -> Params:
    """Convert an nn.GRU-style checkpoint (gru_enc.*, gru_dec.*, out.*):
    split the stacked (r|z|n) gate matrices; fold the input and hidden
    biases of r and z, keep the n gate's two apart."""
    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    out = {}
    for prefix, tname in (("enc", "gru_enc"), ("dec", "gru_dec")):
        w_ih = arr(sd[f"{tname}.weight_ih_l0"])   # [3H, in]
        w_hh = arr(sd[f"{tname}.weight_hh_l0"])   # [3H, H]
        H = w_hh.shape[1]
        b_ih = np.broadcast_to(arr(sd.get(f"{tname}.bias_ih_l0", 0)),
                               (3 * H,))
        b_hh = np.broadcast_to(arr(sd.get(f"{tname}.bias_hh_l0", 0)),
                               (3 * H,))
        for i, gate in enumerate(("r", "z", "n")):
            rows = slice(i * H, (i + 1) * H)
            out[f"{prefix}_w_i{gate}"] = w_ih[rows].T
            out[f"{prefix}_w_h{gate}"] = w_hh[rows].T
            if gate == "n":
                out[f"{prefix}_b_n"] = b_ih[rows]
                out[f"{prefix}_b_hn"] = b_hh[rows]
            else:
                out[f"{prefix}_b_{gate}"] = b_ih[rows] + b_hh[rows]
    out["out_w"] = arr(sd["out.weight"]).T
    out["out_b"] = arr(sd["out.bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), device=device)
            for k, v in out.items()}
