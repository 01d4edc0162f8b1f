"""Per-frame fitting and sequential smoothing (port of
fpv4d/solve/frame_fit.py).

Each frame of a [T, 75] clip is re-fitted with num_iter Adam steps (lr
0.1 by default) in the 78-d 6D-rotation layout: frame 0 toward itself
(L1 reconstruction + VPoser prior), frame t toward itself plus an L1
pull of its betas+pose slice toward frame t-1's result
(``fit_sequential``) or of its pose latent toward a GRU motion prior's
prediction (``fit_sequential_motion``):
  * ``fit_independent``: every frame at once, as ONE Adam over [T, 78]
    on the SUM of the per-frame losses (a per-frame Adam, since Adam is
    elementwise; a mean would scale every gradient by 1/T, and Adam's
    eps is not scale-free);
  * ``fit_sequential`` / ``fit_sequential_motion``: strictly sequential,
    ONE Adam whose moments and step count persist across frames (the
    count reaches T*num_iter); each frame restarts x at its target.
The L1 terms go through ops/losses.py's |x| with JAX's derivative at 0:
x starts exactly at the target, so every reconstruction residual is 0
at a frame's first step.

Entry points run on `device` (default the card); results are [T, 75]
numpy arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fpv4d_torch.config import FrameFitConfig
from fpv4d_torch.core import rotations
from fpv4d_torch.models import motion_gru
from fpv4d_torch.models import params as P
from fpv4d_torch.ops import losses

# the pose latent is the same slice of the 75-d and 78-d layouts, so the
# prior and the motion term read x directly (params_to_3d only rewrites
# the global orientation)
_A6, _B6 = P.VPOSER_SLICE_6D


def _frame_loss(x_6d: torch.Tensor, target_6d: torch.Tensor,
                weights) -> torch.Tensor:
    """rec (L1 in 6D space) + VPoser latent prior per frame: [..., 78]
    -> [...]."""
    rec = weights.rec * torch.mean(losses._abs(target_6d - x_6d), dim=-1)
    prior = weights.vposer * torch.mean(x_6d[..., _A6:_B6] ** 2, dim=-1)
    return rec + prior


def _smooth_term(x_6d: torch.Tensor, prev_6d: torch.Tensor) -> torch.Tensor:
    """L1 pull of the betas+pose slice toward the previous frame."""
    a, b = P.SMOOTH_SLICE_6D
    return losses.l1(prev_6d[a:b], x_6d[a:b])


def _adam_steps(loss_fn, x: torch.Tensor, opt: torch.optim.Adam,
                num_iter: int) -> None:
    """num_iter Adam steps of loss_fn on x, in place."""
    for _ in range(num_iter):
        opt.zero_grad(set_to_none=False)
        loss_fn(x).backward()
        opt.step()


def _targets(body_75, device) -> torch.Tensor:
    body = torch.as_tensor(np.asarray(body_75, np.float32), device=device)
    return rotations.params_to_6d(body)


def fit_independent(body_75: np.ndarray,
                    config: FrameFitConfig = FrameFitConfig(),
                    device="cuda") -> np.ndarray:
    """Re-fit every frame on its own, all frames at once. [T,75] ->
    [T,75]."""
    target_6d = _targets(body_75, device)
    x = target_6d.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=config.lr)
    _adam_steps(lambda x: _frame_loss(x, target_6d, config.weights).sum(),
                x, opt, config.num_iter)
    with torch.no_grad():
        return rotations.params_to_3d(x).cpu().numpy()


def _sequential_loss(x, t6, prev, config):
    """Frame loss, plus smooth_mult x the L1 pull toward the previous
    fitted frame when there is one."""
    loss = _frame_loss(x, t6, config.weights)
    if prev is not None:
        loss = loss + config.smooth_mult * _smooth_term(x, prev)
    return loss


def fit_sequential(body_75: np.ndarray,
                   config: FrameFitConfig = FrameFitConfig(),
                   device="cuda") -> np.ndarray:
    """Sequential smoothing: frame 0 rec + prior, frame t > 0 also
    smooth_mult x L1 toward the previous FITTED frame, one Adam state
    throughout. [T,75] -> [T,75]."""
    target_6d = _targets(body_75, device)
    x = target_6d[0].clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=config.lr)
    fitted = torch.empty_like(target_6d)
    for t in range(target_6d.shape[0]):
        t6, prev = target_6d[t], (fitted[t - 1] if t > 0 else None)
        with torch.no_grad():
            x.copy_(t6)
        _adam_steps(lambda x: _sequential_loss(x, t6, prev, config), x, opt,
                    config.num_iter)
        fitted[t] = x.detach()
    return rotations.params_to_3d(fitted).cpu().numpy()


def _motion_loss(x, t6, pose_pred, config):
    """Frame loss, plus the L1 pull of the pose latent toward the GRU's
    prediction when there is one."""
    loss = _frame_loss(x, t6, config.weights)
    if pose_pred is not None:
        loss = loss + losses.l1(x[_A6:_B6], pose_pred)
    return loss


def fit_sequential_motion(body_75: np.ndarray,
                          gru_params: Dict[str, torch.Tensor],
                          config: FrameFitConfig = FrameFitConfig(),
                          device="cuda") -> np.ndarray:
    """GRU-motion-prior variant: the pose latent of frame t > 0 is pulled
    (L1) toward the GRU's next-pose prediction from the previous fitted
    frame, with the encoder/decoder hidden states carried along. Frame 0
    makes no GRU step: the hidden states stay zero until frame 1.
    [T,75] -> [T,75]."""
    target_6d = _targets(body_75, device)
    gru = {k: v.to(device) for k, v in gru_params.items()}
    a75, b75 = P.VPOSER_SLICE
    x = target_6d[0].clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=config.lr)
    h_enc = torch.zeros((1, motion_gru.H_ENC), device=device)
    h_dec = torch.zeros((1, motion_gru.H_DEC), device=device)
    fitted, pose_pred = [], None
    for t in range(target_6d.shape[0]):
        t6 = target_6d[t]
        if t > 0:
            with torch.no_grad():
                pred, h_enc, h_dec = motion_gru.forward_seq(
                    gru, fitted[-1][a75:b75][None], seq_length=1,
                    h_enc=h_enc, h_dec=h_dec)
            pose_pred = pred[0, :, -1]
        with torch.no_grad():
            x.copy_(t6)
        _adam_steps(lambda x: _motion_loss(x, t6, pose_pred, config), x,
                    opt, config.num_iter)
        with torch.no_grad():
            fitted.append(rotations.params_to_3d(x[None])[0])
    return torch.stack(fitted).cpu().numpy()
