"""Plain PyTorch emulation of the Gram-form filter that the kernels K1
and K2 run on the tensor cores (csrc/gram_nn.cuh holds the kernels'
routine and the margin's proof).

A block of queries is centred on its first query c; with a = fl(x - c)
and b = fl(y - c) the filter value of a (query, point) pair is
F~ = x'.y' with x' = [-2a, 1] and y' = [b, fl(|b|^2)], each factor split
into hi + lo parts (bf16 as in the kernels, or TF32 for comparison) and
summed as hi.hi + hi.lo + lo.hi. A point can be the exact winner only if
F~ <= theta(d*), d* the winner's exact distance; every point that passes
is re-evaluated exactly by the kernels.

The emulation takes the products exactly (each is exact in f64) and
rounds their sum once to f32, where the tensor cores truncate; the
margin's accumulation term covers that difference. ``theta`` is
evaluated in f64 and rounded up to f32, never above the kernels' own
upward-rounded f32 evaluation. The tests use this module to prove the
margin on the CPU; nothing on the solve path calls it.

K2 (csrc/chamfer_nn.cu) folds each row's threshold into the product:
-tau (``neg_tau``: tau = theta + 1.03 * 2^-16 |theta| + 1e-20, rounded
up) split into three parts whose sum is -tau exactly (``split3``) sits
in the row against a column of ones, and a point passes when the sign
bit of fl(F~ - tau) is set (``block_passes(..., folded=True)``). K1
tests F~ <= theta.
"""
from __future__ import annotations

from typing import Tuple

import torch

U = 2.0 ** -24
ABS = 1e-20          # absolute floor of the margin
PAD_YY = 1e30        # |y|^2 of padded and invalid points
NO_BOUND = -2.0 ** 126   # K2's -tau of a row with no threshold yet

# (e_a, e_b) of the margin for each split: the split's error per product
# (3.03 s^2 with s the part's unit roundoff, 1.01 s^2 for the "1"
# column) plus 1.02 * 2^-16 for the tensor cores' accumulation and, in
# e_b, 3.01 u for fl(|b|^2); rounded up as in csrc/gram_nn.cuh
EPS = {"bf16": (4.1 * 2.0 ** -16, 2.1 * 2.0 ** -16),
       "tf32": (1.1 * 2.0 ** -16, 1.1 * 2.0 ** -16)}


def _round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 stored mantissa bits; ties away
    from zero, as cvt.rna.tf32.f32), as f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor, kind: str = "bf16"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 v -> (hi, lo) in f32, each exact in the split's type:
    hi = round(v), lo = round(v - hi) (v - hi is exact in f32)."""
    if kind == "bf16":
        hi = v.to(torch.bfloat16).float()
        return hi, (v - hi).to(torch.bfloat16).float()
    hi = _round_tf32(v)
    return hi, _round_tf32(v - hi)


def _f32_up(v: torch.Tensor) -> torch.Tensor:
    """f64 -> the least f32 at or above it."""
    f = v.float()
    return torch.where(f.double() < v,
                       torch.nextafter(f, torch.full_like(f, float("inf"))),
                       f)


def _f32_down(v: torch.Tensor) -> torch.Tensor:
    f = v.float()
    return torch.where(f.double() > v,
                       torch.nextafter(f, torch.full_like(f, -float("inf"))),
                       f)


def row_bounds(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centred queries a [n, 3] f32 -> (X >= |a|, K_lo <= |a|^2), f32."""
    k = (a.double() ** 2).sum(-1)
    return _f32_up(k.sqrt()), _f32_down(k)


def theta(d_ub: torch.Tensor, X: torch.Tensor, K_lo: torch.Tensor,
          kind: str = "bf16") -> torch.Tensor:
    """The threshold on F~ of rows whose best exact distance is at most
    d_ub (csrc/gram_nn.cuh, theta), +inf where d_ub is not finite."""
    e_a, e_b = EPS[kind]
    d, X = d_ub.double(), X.double()
    R = (d * (1 + 6 * U)).sqrt()
    B = (X + R) * (1 + 4 * U)
    XB = X + B
    m = (6 * U * d + 2.02 * U * XB * (R + U * XB) + 2 * e_a * X * B
         + e_b * B * B + ABS)
    th = _f32_up(d - K_lo.double() + m)
    return torch.where(torch.isfinite(d_ub), th,
                       torch.full_like(th, float("inf")))


def upper_d(v: torch.Tensor, X: torch.Tensor, kind: str = "bf16"
            ) -> torch.Tensor:
    """An upper bound on the exact distance of any point whose filter
    value is v, for rows with X >= |a| (csrc/gram_nn.cuh, upper_d); the
    kernels seed each row's threshold with it before any re-check."""
    e_a, e_b = EPS[kind]
    v, X = v.double(), X.double()
    ax = (1 + 2.0 ** -13) * X
    Bv = (ax + (ax * ax + v.clamp(min=0)).sqrt()) / (1 - 2.0 ** -14)
    s2 = v + 2 * e_a * X * Bv + e_b * Bv * Bv + X * X
    S = s2.clamp(min=0).sqrt() + 1.01 * U * (X + Bv)
    up = _f32_up(S * S * (1 + 6 * U) + ABS)
    return torch.where(torch.isfinite(v), up,
                       torch.full_like(up, float("inf")))


def neg_tau(th: torch.Tensor) -> torch.Tensor:
    """K2's -tau of thresholds th (csrc/gram_nn.cuh, offset): tau =
    th + 1.03 * 2^-16 |th| + 1e-20 rounded up to f32; NO_BOUND where th
    is not finite."""
    d = th.double()
    tau = _f32_up(d + 1.03 * 2.0 ** -16 * d.abs() + ABS)
    return torch.where(torch.isfinite(th), -tau,
                       torch.full_like(tau, NO_BOUND))


def split3(v: torch.Tensor, kind: str = "bf16"
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 v -> three parts (f32, each exact in the split's type) whose
    sum is v exactly: p1 = round(v), p2 = round(v - p1),
    p3 = round(v - p1 - p2), each difference exact in f32."""
    p1 = split(v, kind)[0]
    p2, p3 = split(v - p1, kind)
    return p1, p2, p3


def filter_values(a: torch.Tensor, b: torch.Tensor, yy: torch.Tensor,
                  kind: str = "bf16", neg: torch.Tensor = None
                  ) -> torch.Tensor:
    """F~ [n, M] f32 of centred queries a [n, 3] against centred points
    b [M, 3] with |y|^2 column yy [M] (PAD_YY for invalid points); with
    -tau per row `neg` [n], F~ - tau, the three parts of -tau summed
    with the products (K2's folded form)."""
    xp = torch.cat([-2.0 * a, torch.ones_like(a[:, :1])], 1)
    yp = torch.cat([b, yy[:, None]], 1)
    xh, xl = split(xp, kind)
    yh, yl = split(yp, kind)
    xh, xl, yh, yl = (t.double() for t in (xh, xl, yh, yl))
    f = xh @ yh.T + xh @ yl.T + xl @ yh.T
    if neg is not None:
        f = f + sum(p.double() for p in split3(neg, kind))[:, None]
    return f.float()


def centred_points(y: torch.Tensor, c: torch.Tensor,
                   valid: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b = fl(y - c), yy = fl(|b|^2) summed (bx^2 + by^2) + bz^2), with
    b = 0 and yy = PAD_YY where a point is invalid."""
    b = y - c
    yy = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1]) + b[:, 2] * b[:, 2]
    if valid is not None:
        b = torch.where(valid[:, None], b, 0.0)
        yy = torch.where(valid, yy, PAD_YY)
    return b, yy


def block_passes(x: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
                 valid: torch.Tensor = None, kind: str = "bf16",
                 folded: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of queries x [n, 3], centred on x[0], against points
    y [M, 3] whose exact distances (the plain version's) are d [n, M]:
    whether every point at a row's least exact distance d* (its winner
    and any tie) passes the filter at theta(d*) [n] bool, and each row's
    count of points that pass there [n]. A point passes when
    F~ <= theta(d*), or with `folded` (K2) when the sign bit of
    fl(F~ - tau) is set, tau that threshold's (neg_tau)."""
    c = x[0]
    a = x - c
    X, K_lo = row_bounds(a)
    b, yy = centred_points(y, c, valid)
    th = theta(d.min(1).values, X, K_lo, kind)
    if folded:
        v = filter_values(a, b, yy, kind, neg=neg_tau(th))
        ok = torch.signbit(v)
    else:
        ok = filter_values(a, b, yy, kind) <= th[:, None]
    ties = d == d.min(1, keepdim=True).values
    return (ok | ~ties).all(1), ok.sum(1)
