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
The Adam is solve/adam.py's (optax's arithmetic, its state on the
device). The L1 terms go through ops/losses.py's |x| with JAX's
derivative at 0: x starts exactly at the target, so every
reconstruction residual is 0 at a frame's first step.

The sequential variants' unit of work is the reference's scan body
``fit_frame`` (fpv4d/solve/frame_fit.py:103-118, :138-165): a frame body
that reads its frame index t from a device counter, copies target row t
into x, runs the frame's num_iter Adam steps on the frame loss plus w[t]
times the pull (w a device [T] vector with w[0] = 0, as the reference's
:117; the row gathered as "previous" at t = 0 is row 0 of the zeroed
buffer, finite and weighted 0), writes row t of the fitted [T, 78]
buffer and advances t. The motion variant's GRU step runs inside it, its
hidden-state update masked by w as at :152-153, so frame 0 makes none.
The bodies run through a phase program (solve/step_graph.py): on the
card each body (``fit_independent``: each step) is captured once as a
CUDA graph and replayed, frame after frame (``step_graphs``); eagerly,
the same body runs once per frame.

Entry points run on `device` (default the card); results are [T, 75]
numpy arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from fpv4d_torch.config import FrameFitConfig
from fpv4d_torch.core import rotations
from fpv4d_torch.models import motion_gru
from fpv4d_torch.models import params as P
from fpv4d_torch.ops import losses
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.adam import Adam

# the pose latent is the same slice of the 75-d and 78-d layouts, so the
# prior and the motion term read x directly (params_to_3d only rewrites
# the global orientation)
_A6, _B6 = P.VPOSER_SLICE_6D

# host seconds of each capture in the last smoother run of this process
# (empty on the eager route)
capture_seconds: Dict[str, float] = {}


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


def _adam_steps(loss_fn, x: torch.Tensor, opt: Adam,
                num_iter: int) -> torch.Tensor:
    """num_iter Adam steps of loss_fn on x, in place; the last loss."""
    for _ in range(num_iter):
        opt.zero_grad()
        loss = loss_fn(x)
        loss.backward()
        opt.step()
    return loss.detach()


def _targets(body_75, device) -> torch.Tensor:
    body = torch.as_tensor(np.asarray(body_75, np.float32), device=device)
    return rotations.params_to_6d(body)


def _run(name: str, body: Callable[[], torch.Tensor], num: int, device,
         step_graphs: Optional[bool]) -> None:
    """num runs of `body` through one phase program on the route
    `step_graphs` names (solve/step_graph.use_graphs)."""
    program = step_graph.PhaseProgram(
        device, step_graph.use_graphs(device, step_graphs))
    try:
        program.run((name,), body, num)
    finally:
        capture_seconds.clear()
        capture_seconds.update({k[0]: s for k, s in
                                program.capture_seconds.items()})
        program.close()


def fit_independent(body_75: np.ndarray,
                    config: FrameFitConfig = FrameFitConfig(),
                    device="cuda",
                    step_graphs: Optional[bool] = None) -> np.ndarray:
    """Re-fit every frame on its own, all frames at once: num_iter steps
    of one Adam over [T, 78], each step captured once on the card.
    [T,75] -> [T,75]."""
    target_6d = _targets(body_75, device)
    x = target_6d.clone().requires_grad_(True)
    opt = Adam([x], lr=config.lr)

    def step():
        return _adam_steps(
            lambda x: _frame_loss(x, target_6d, config.weights).sum(), x,
            opt, 1)

    _run("independent", step, config.num_iter, device, step_graphs)
    with torch.no_grad():
        return rotations.params_to_3d(x).cpu().numpy()


def _frame_state(body_75, config, device):
    """The sequential variants' device state: targets [T, 78], x, the one
    Adam, the fitted buffer [T, 78] (zeros), the pull weights w [T] (w[0]
    = 0) and the frame counter t [1]."""
    target_6d = _targets(body_75, device)
    x = target_6d[0].clone().requires_grad_(True)
    fitted = torch.zeros_like(target_6d)
    w = torch.ones(target_6d.shape[0], device=target_6d.device)
    w[0] = 0.0
    t = torch.zeros(1, dtype=torch.long, device=target_6d.device)
    return target_6d, x, Adam([x], lr=config.lr), fitted, w, t


def _frame_rows(target_6d, fitted, w, t):
    """Frame t's target [78], the previous fitted row [1, 78] (row 0 at t
    = 0) and w[t] [1], gathered on the device."""
    prev = fitted.index_select(0, torch.clamp(t - 1, min=0))
    return target_6d.index_select(0, t)[0], prev, w.index_select(0, t)


def _end_frame(x, fitted, t) -> None:
    """Row t of `fitted` <- x; t advances."""
    with torch.no_grad():
        fitted.index_copy_(0, t, x.detach()[None])
        t.add_(1)


def fit_sequential(body_75: np.ndarray,
                   config: FrameFitConfig = FrameFitConfig(),
                   device="cuda",
                   step_graphs: Optional[bool] = None) -> np.ndarray:
    """Sequential smoothing: frame 0 rec + prior, frame t > 0 also
    smooth_mult x L1 toward the previous FITTED frame, one Adam state
    throughout; one frame body per frame, captured once on the card.
    [T,75] -> [T,75]."""
    target_6d, x, opt, fitted, w, t = _frame_state(body_75, config, device)

    def frame():
        t6, prev, w_t = _frame_rows(target_6d, fitted, w, t)
        with torch.no_grad():
            x.copy_(t6)
        loss = _adam_steps(
            lambda x: _frame_loss(x, t6, config.weights)
            + w_t[0] * config.smooth_mult * _smooth_term(x, prev[0]),
            x, opt, config.num_iter)
        _end_frame(x, fitted, t)
        return loss

    _run("sequential", frame, target_6d.shape[0], device, step_graphs)
    with torch.no_grad():
        return rotations.params_to_3d(fitted).cpu().numpy()


def fit_sequential_motion(body_75: np.ndarray,
                          gru_params: Dict[str, torch.Tensor],
                          config: FrameFitConfig = FrameFitConfig(),
                          device="cuda",
                          step_graphs: Optional[bool] = None) -> np.ndarray:
    """GRU-motion-prior variant: the pose latent of frame t > 0 is pulled
    (L1) toward the GRU's next-pose prediction from the previous fitted
    frame, with the encoder/decoder hidden states carried along. Frame 0
    makes no GRU step: its hidden-state update is masked by w[0] = 0, so
    the states stay zero until frame 1. [T,75] -> [T,75]."""
    target_6d, x, opt, fitted, w, t = _frame_state(body_75, config, device)
    gru = {k: v.to(device) for k, v in gru_params.items()}
    h_enc = torch.zeros((1, motion_gru.H_ENC), device=target_6d.device)
    h_dec = torch.zeros((1, motion_gru.H_DEC), device=target_6d.device)

    def frame():
        t6, prev, w_t = _frame_rows(target_6d, fitted, w, t)
        with torch.no_grad():
            pred, h_enc_n, h_dec_n = motion_gru.forward_seq(
                gru, prev[:, _A6:_B6], seq_length=1, h_enc=h_enc,
                h_dec=h_dec)
            h_enc.copy_(torch.where(w_t > 0, h_enc_n, h_enc))
            h_dec.copy_(torch.where(w_t > 0, h_dec_n, h_dec))
            x.copy_(t6)
        pose_pred = pred[0, :, -1]
        loss = _adam_steps(
            lambda x: _frame_loss(x, t6, config.weights)
            + w_t[0] * losses.l1(x[_A6:_B6], pose_pred),
            x, opt, config.num_iter)
        _end_frame(x, fitted, t)
        return loss

    _run("motion", frame, target_6d.shape[0], device, step_graphs)
    with torch.no_grad():
        return rotations.params_to_3d(fitted).cpu().numpy()
