"""Rotation codecs: axis-angle <-> rotation matrix <-> quaternion <-> 6D
(port of fpv4d/core/rotations.py).

Conventions match the reference exactly:
  * 6D representation = first two COLUMNS of the rotation matrix,
    flattened row-major as ``mat[..., :, :2].reshape(6)``.
  * ``matrot_to_aa`` goes through a quaternion.
Singular configurations use the double-``where`` pattern: the
denominator is made safe in the unselected branch too, so gradients
stay finite at zero angle. Clamps are torch.maximum/minimum, whose
gradient at a tie is JAX's (split evenly), against bounds made on the
device (``full_like``), never uploaded from the host: VPoser's decode
runs these codecs inside the keypoint fit's captured steps.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def aa_to_matrot(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues),
    smooth at theta=0."""
    theta2 = torch.sum(aa * aa, dim=-1)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    K2 = torch.matmul(K, K)
    return eye + s[..., None, None] * K + c[..., None, None] * K2


def matrot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w,x,y,z),
    branchless 4-case Shepperd selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        s = torch.sqrt(torch.maximum(t, torch.full_like(t, _EPS))) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1), s

    q0, s0 = cand(1.0 + tr, (1.0 + tr), m21 - m12, m02 - m20, m10 - m01)
    q1, s1 = cand(1.0 + m00 - m11 - m22, m21 - m12,
                  (1.0 + m00 - m11 - m22), m01 + m10, m02 + m20)
    q2, s2 = cand(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10,
                  (1.0 - m00 + m11 - m22), m12 + m21)
    q3, s3 = cand(1.0 - m00 - m11 + m22, m10 - m01, m02 + m20,
                  m12 + m21, (1.0 - m00 - m11 + m22))
    cands = torch.stack([q0, q1, q2, q3], dim=-2)          # [..., 4, 4]
    pivots = torch.stack([s0, s1, s2, s3], dim=-1)         # [..., 4]
    idx = torch.argmax(pivots, dim=-1)
    onehot = torch.arange(4, device=R.device) == idx[..., None]
    q = torch.sum(cands * onehot[..., None].to(cands.dtype), dim=-2)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w,x,y,z) -> axis-angle [..., 3],
    grad-safe at the identity. w is clipped as jnp.clip does, by a
    maximum and a minimum, which split the gradient evenly where w is
    exactly +-1 (a rotation within ~5e-4 rad of the identity rounds
    there); torch.clamp would pass all of it."""
    w = q[..., 0]
    one = torch.ones_like(w)
    w = torch.minimum(torch.maximum(w, -one), one)
    v = q[..., 1:]
    v2 = torch.sum(v * v, dim=-1)
    small = v2 < 1e-12
    safe_v2 = torch.where(small, torch.ones_like(v2), v2)
    vn = torch.sqrt(safe_v2)
    theta = 2.0 * torch.atan2(torch.where(small, torch.zeros_like(vn), vn),
                              w)
    k = torch.where(small, torch.full_like(vn, 2.0), theta / vn)
    return v * k[..., None]


def matrot_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    return quat_to_aa(matrot_to_quat(R))


def quat_to_matrot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
                     2 * z * x + 2 * w * y], dim=-1),
        torch.stack([2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
                     2 * y * z - 2 * w * x], dim=-1),
        torch.stack([2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x,
                     1 - 2 * x * x - 2 * y * y], dim=-1),
    ], dim=-2)


def matrot_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6]: first two columns, row-major flatten."""
    return R[..., :, :2].reshape(R.shape[:-2] + (6,))


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize along the last axis with finite gradients at v=0."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return torch.where(small, torch.zeros_like(v), v / n)


def rot6d_to_matrot(r6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt."""
    m = r6.reshape(r6.shape[:-1] + (3, 2))
    a1, a2 = m[..., :, 0], m[..., :, 1]
    b1 = _safe_normalize(a1)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _safe_normalize(a2 - dot * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def aa_to_rot6d(aa: torch.Tensor) -> torch.Tensor:
    return matrot_to_rot6d(aa_to_matrot(aa))


def rot6d_to_aa(r6: torch.Tensor) -> torch.Tensor:
    return matrot_to_aa(rot6d_to_matrot(r6))


def params_to_6d(x: torch.Tensor) -> torch.Tensor:
    """[..., 3+3+K] aa layout -> [..., 3+6+K] 6D layout (only the
    global_orient slot [3:6] is re-encoded)."""
    xt, xr, xb = x[..., :3], x[..., 3:6], x[..., 6:]
    return torch.cat([xt, aa_to_rot6d(xr), xb], dim=-1)


def params_to_3d(x: torch.Tensor) -> torch.Tensor:
    """[..., 3+6+K] 6D layout -> [..., 3+3+K] aa layout."""
    xt, xr, xb = x[..., :3], x[..., 3:9], x[..., 9:]
    return torch.cat([xt, rot6d_to_aa(xr), xb], dim=-1)
