"""Loss terms of the capture pipeline (port of fpv4d/ops/losses.py)."""
from __future__ import annotations

import functools

import torch

from fpv4d_torch.core.dct import dct_basis

EPS_CONTACT = 1e-4


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's derivative at 0: JAX differentiates abs
    as select(x >= 0, g, -g), so d|x|/dx = +1 at x = 0, where
    torch.abs gives 0. The L1 terms meet exact zeros (constant betas,
    re-seeded frames), and the two rules then move Adam differently."""
    return torch.where(x >= 0, x, -x)


def rec_l1(target_6d: torch.Tensor, rec_6d: torch.Tensor,
           frame_weights: torch.Tensor) -> torch.Tensor:
    """Masked L1 reconstruction in 6D-param space (frame_weights [T],
    0 for outlier frames)."""
    return torch.mean(_abs(target_6d - rec_6d)
                      * frame_weights[:, None])


def vposer_prior(latent: torch.Tensor) -> torch.Tensor:
    """mean(latent^2)."""
    return torch.mean(latent ** 2)


def second_order_smoothness(seq: torch.Tensor) -> torch.Tensor:
    """mean |d2/dt2 seq| along axis 0."""
    d = seq[:-1] - seq[1:]
    return torch.mean(_abs(d[:-1] - d[1:]))


def first_order_smoothness(seq: torch.Tensor) -> torch.Tensor:
    """mean |d/dt seq| along axis 0."""
    return torch.mean(_abs(seq[:-1] - seq[1:]))


def robust_contact(dist_sq: torch.Tensor) -> torch.Tensor:
    """mean( sqrt(d)/(sqrt(d)+1) ), with sqrt(d + 1e-4)."""
    r = torch.sqrt(dist_sq + EPS_CONTACT)
    return torch.mean(r / (r + 1.0))


def robust_contact_per_frame(dist_sq: torch.Tensor) -> torch.Tensor:
    """[T, N] -> [T] per-frame robust contact."""
    r = torch.sqrt(dist_sq + EPS_CONTACT)
    return torch.mean(r / (r + 1.0), dim=-1)


def gm(e: torch.Tensor) -> torch.Tensor:
    """Geman-McClure-style saturation e/(e+1)."""
    return e / (e + 1.0)


@functools.lru_cache(maxsize=None)
def _step_basis(window: int, k: int, device: torch.device) -> torch.Tensor:
    """dct_basis made once per shape and device: a step reads it without
    a host-to-device copy (a captured step cannot make one)."""
    return dct_basis(window, k, device)


def dct_trajectory(joints_world: torch.Tensor, c_dct: torch.Tensor,
                   window: int = 60) -> torch.Tensor:
    """Low-frequency DCT trajectory prior: joints_world [T, J, 3] with
    T = num_windows * window, c_dct [W, J, 3, K]; e = (traj - basis @
    coeffs)^2 per (window, joint, axis), loss = mean of sum_t gm(e)."""
    T, J, _ = joints_world.shape
    W, Jc, _, K = c_dct.shape
    if W * window != T or Jc > J:
        raise ValueError(f"c_dct {tuple(c_dct.shape)} does not tile "
                         f"joints {tuple(joints_world.shape)}")
    basis = _step_basis(window, K, joints_world.device)
    traj = joints_world[:, :Jc, :].reshape(W, window, Jc, 3)
    rec = torch.einsum("tk,wjak->wtja", basis, c_dct)
    e = (traj - rec) ** 2
    return torch.mean(torch.sum(gm(e), dim=1))


def dct_encode(joints_world: torch.Tensor, window: int = 60,
               k: int = 5) -> torch.Tensor:
    """Least-squares DCT coefficients of joint trajectories (orthonormal
    projection): [T,J,3] -> [W,J,3,K]."""
    T, J, _ = joints_world.shape
    W = T // window
    basis = dct_basis(window, k, joints_world.device)
    traj = joints_world.reshape(W, window, J, 3)
    return torch.einsum("tk,wtja->wjak", basis, traj)


def foot_skate(contact_verts_left: torch.Tensor,
               contact_verts_right: torch.Tensor,
               weight_right: torch.Tensor) -> torch.Tensor:
    """Planted-foot anti-skate term: weights below 0.5 are hard-zeroed;
    each foot's frame difference is L1-penalized by its planted weight."""
    w_r = torch.where(weight_right < 0.5, 0.0, weight_right)
    w_l_full = 1.0 - weight_right
    w_l = torch.where(w_l_full < 0.5, 0.0, w_l_full)
    diff_l = contact_verts_left[:-1] - contact_verts_left[1:]
    diff_r = contact_verts_right[:-1] - contact_verts_right[1:]
    return (torch.mean(_abs(diff_l * w_l[1:, None, None]))
            + torch.mean(_abs(diff_r * w_r[1:, None, None])))


def planted_foot_weight(dist_left: torch.Tensor,
                        dist_right: torch.Tensor) -> torch.Tensor:
    """weight_right = left/(left+right): large when the right foot is
    closer to the scene (planted)."""
    return dist_left / (dist_left + dist_right + 1e-12)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain mean-L1."""
    return torch.mean(_abs(a - b))
