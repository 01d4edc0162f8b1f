"""Exact brute-force nearest neighbour: hand-written CUDA kernel K2 and
its plain PyTorch version.

Replaces the TPU kernel ``_nn_kernel`` of fpv4d/ops/chamfer_pallas.py
(launched from ``_nn_forward``, public entries ``nn_distance`` and
``chamfer``): for each query x[..., :] the nearest of M cloud points y,
with ties to the smallest index. ``nn_distance`` returns the squared
distance and that index and is differentiable in x and y, with the
reference's VJP: dx = g * 2 (x - y[idx]), and -dx scatter-added into dy
(``index_add_``, computed only when y needs a gradient).

Clouds may carry a leading clip axis, y [C, M, 3] against x [C, ..., 3]
(the multi-clip fleet's padded scenes, where the reference vmaps its
kernel): each clip searches its own cloud, the indices are per clip,
and the kernel makes one launch for all clips.

The TPU kernel selects with a folded Gram form (|y|^2 - 2 x.y in bf16x3
emulation), whose winners can differ from exact differences among
near-ties. The kernel here (csrc/chamfer_nn.cu) runs the same folded
product on the tensor cores (wgmma, with each query's threshold folded
into the product), but only as a filter: every point that comes within
a proven margin of a query's best is re-evaluated in the difference
form (dx*dx + dy*dy) + dz*dz, in f32 without FMA contraction, so the
kernel is bit-identical to ``nn_distance_plain`` on the card.
``filter_emulated`` repeats the filter in plain PyTorch (ops/gram_nn.py)
so the CPU tests can prove that the exact winner always passes it, and
``filter_probe`` (tests only) returns the card's raw filter values.

While tracing is on (utils/observability.py) each launch of the kernel
counts ``k2/cuda`` and each call of ``nn_index`` on CPU tensors
``k2/plain``.

The kernel is built with nvcc at first use (``build()``, see
ops/cuda_build.py); importing this module needs no CUDA toolkit.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from fpv4d_torch.ops import cuda_build, gram_nn
from fpv4d_torch.utils import observability as OBS

SRC = cuda_build.CSRC / "chamfer_nn.cu"
_launch = None          # the kernel's C entry point, once built
_probe = None           # the filter probe's C entry point (tests only)
build_log = ""

# the plain version's [chunk, M] intermediates hold at most this many
# elements each (256 MB in f32)
_PLAIN_ELEMS = 1 << 26

# queries per tile of the kernel, all centred on the tile's first
BLOCK_QUERIES = 384


def build() -> float:
    """Compile (if not already built for this source) and load the
    kernel; returns the seconds it took."""
    global _launch, build_log
    if _launch is not None:
        return 0.0
    t0 = time.perf_counter()
    ptr, i32 = cuda_build.POINTER, cuda_build.INT
    _launch, build_log = cuda_build.load_function(
        SRC, "chamfer_nn_forward", [ptr] * 5 + [i32] * 3 + [ptr])
    return time.perf_counter() - t0


def _check_cloud(y: torch.Tensor, x: Optional[torch.Tensor] = None):
    """y is [M, 3], or [C, M, 3] with queries x [C, ..., 3]."""
    if y.ndim not in (2, 3) or y.shape[-1] != 3:
        raise ValueError(f"the cloud must be [M, 3] or [C, M, 3], got "
                         f"{tuple(y.shape)}")
    if y.shape[-2] == 0:
        raise ValueError("nearest neighbour in an empty cloud (M = 0)")
    if y.ndim == 3 and x is not None and (x.ndim < 2
                                          or x.shape[0] != y.shape[0]):
        raise ValueError(f"clouds {tuple(y.shape)} need queries "
                         f"[C, ..., 3] of the same C, got {tuple(x.shape)}")


def dist_sq_qm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances [Q, M] of x [Q, 3] to y [M, 3], summed
    (dx*dx + dy*dy) + dz*dz, each op unfused (the kernel's order)."""
    dx = x[:, None, 0] - y[None, :, 0]
    dy = x[:, None, 1] - y[None, :, 1]
    dz = x[:, None, 2] - y[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def nn_distance_plain(x: torch.Tensor, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: x [..., 3], y [M, 3] -> (dist [...]
    f32, idx [...] int32), in query chunks whose [chunk, M] intermediates
    stay under a fixed size; torch.min keeps the smallest index among
    ties. With clouds y [C, M, 3], each clip x[c] against y[c]."""
    _check_cloud(y, x)
    if y.ndim == 3:
        out = [nn_distance_plain(xc, yc) for xc, yc in zip(x, y)]
        return (torch.stack([d for d, _ in out]),
                torch.stack([i for _, i in out]))
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3)
    chunk = max(1, _PLAIN_ELEMS // y.shape[0])
    ds, ids = [], []
    for s in range(0, xf.shape[0], chunk):
        d, i = torch.min(dist_sq_qm(xf[s:s + chunk], y), dim=1)
        ds.append(d)
        ids.append(i.to(torch.int32))
    if not ds:
        return (x.new_empty(batch_shape),
                torch.empty(batch_shape, dtype=torch.int32,
                            device=x.device))
    return (torch.cat(ds).reshape(batch_shape),
            torch.cat(ids).reshape(batch_shape))


def nn_distance_cuda(x: torch.Tensor, y: torch.Tensor,
                     rechecks: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the card; same contract as nn_distance_plain. Raises on
    anything the kernel does not take. `rechecks`, an int32 tensor of
    x's batch shape on the same card, receives each query's number of
    exact re-evaluations (the solve path passes none)."""
    if not (x.is_cuda and y.is_cuda):
        raise ValueError("nn_distance_cuda takes CUDA tensors")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("nn_distance_cuda takes f32 tensors")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if x.shape[-1] != 3:
        raise ValueError(f"queries must be [..., 3], got {tuple(x.shape)}")
    _check_cloud(y, x)
    batch_shape = x.shape[:-1]
    C = y.shape[0] if y.ndim == 3 else 1
    Q, M = x.numel() // (3 * C), y.shape[-2]
    if 3 * Q >= 2 ** 31 or 3 * M >= 2 ** 31:
        raise ValueError("nn_distance_cuda: tensors exceed int32 indexing")
    if C > 65_535:
        raise ValueError(f"nn_distance_cuda: {C} clips, at most 65,535")
    dist = torch.empty(batch_shape, dtype=torch.float32, device=x.device)
    idx = torch.empty(batch_shape, dtype=torch.int32, device=x.device)
    if rechecks is not None and (
            rechecks.dtype != torch.int32 or rechecks.device != x.device
            or rechecks.shape != batch_shape
            or not rechecks.is_contiguous()):
        raise ValueError("rechecks must be a contiguous int32 tensor of "
                         "the queries' batch shape on their device")
    if Q == 0:
        return dist, idx
    build()
    x, y = x.contiguous(), y.contiguous()
    err = _launch(
        x.data_ptr(), y.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        0 if rechecks is None else rechecks.data_ptr(), Q, M, C,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chamfer_nn kernel launch failed: CUDA error "
                           f"{err}")
    OBS.count("k2/cuda")
    return dist, idx


def filter_probe(x: torch.Tensor, y: torch.Tensor, neg_tau: torch.Tensor
                 ) -> torch.Tensor:
    """Tests only: the card's raw filter values [Q, M] of queries x
    [Q, 3] (Q <= BLOCK_QUERIES, one tile centred on x[0]) against y
    [M, 3], with -tau = neg_tau [Q] folded into the product as K2 folds
    it: F~ - tau, or F~ itself where neg_tau is 0."""
    global _probe
    for name, t in (("x", x), ("y", y), ("neg_tau", neg_tau)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"filter_probe: {name} must be f32 on a card")
    Q, M = x.shape[0], y.shape[0]
    if not (x.shape == (Q, 3) and y.shape == (M, 3)
            and neg_tau.shape == (Q,) and 1 <= Q <= BLOCK_QUERIES
            and M >= 1):
        raise ValueError("filter_probe takes x [Q, 3] (1 <= Q <= 384), "
                         "y [M, 3] (M >= 1), neg_tau [Q]")
    build()
    if _probe is None:
        ptr, i32 = cuda_build.POINTER, cuda_build.INT
        _probe = cuda_build.load_function(SRC, "chamfer_nn_probe",
                                          [ptr] * 4 + [i32] * 2 + [ptr])[0]
    x, y, neg_tau = x.contiguous(), y.contiguous(), neg_tau.contiguous()
    out = torch.empty((Q, M), dtype=torch.float32, device=x.device)
    err = _probe(x.data_ptr(), y.data_ptr(), neg_tau.data_ptr(),
                 out.data_ptr(), Q, M,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filter probe launch failed: CUDA error {err}")
    return out


def filter_emulated(x: torch.Tensor, y: torch.Tensor, kind: str = "bf16"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's filter in plain PyTorch, tiles of BLOCK_QUERIES
    queries centred as the kernel centres them, each query's threshold
    folded into the product as the kernel folds it: (whether each
    query's exact winner and ties pass the filter at the winner's
    distance [...] bool; how many points pass there [...] int64, the
    re-checks a query costs once its winner is found). One cloud
    y [M, 3]."""
    if y.ndim != 2:
        raise ValueError("filter_emulated takes one cloud [M, 3]")
    _check_cloud(y)
    xf = x.reshape(-1, 3)
    won, passes = [], []
    for s in range(0, xf.shape[0], BLOCK_QUERIES):
        xb = xf[s:s + BLOCK_QUERIES]
        w, n = gram_nn.block_passes(xb, y, dist_sq_qm(xb, y), kind=kind,
                                    folded=True)
        won.append(w)
        passes.append(n)
    return (torch.cat(won).reshape(x.shape[:-1]),
            torch.cat(passes).reshape(x.shape[:-1]))


def nn_index(x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the tensors' device: the plain version for CPU
    tensors, the kernel for CUDA tensors (never a fallback)."""
    if x.is_cuda:
        return nn_distance_cuda(x, y)
    OBS.count("k2/plain")
    return nn_distance_plain(x, y)


def _flat_rows(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """idx [...] (per clip for clouds y [C, M, 3]) -> the rows of
    y.reshape(-1, 3) they name, int64 [...]."""
    rows = idx.long()
    if y.ndim == 3:
        off = torch.arange(y.shape[0], device=idx.device) * y.shape[1]
        rows = rows + off.reshape((-1,) + (1,) * (idx.ndim - 1))
    return rows


def scatter_to_cloud(y: torch.Tensor, idx: torch.Tensor,
                     d_near: torch.Tensor) -> torch.Tensor:
    """dy: d_near [..., 3] summed onto the cloud rows idx [...] (each
    clip onto its own cloud for y [C, M, 3])."""
    return torch.zeros_like(y).reshape(-1, 3).index_add_(
        0, _flat_rows(y, idx).reshape(-1),
        d_near.reshape(-1, 3)).reshape(y.shape)


class _NNDistance(torch.autograd.Function):
    """(dist, idx) with the reference's VJP (chamfer_pallas._nn_bwd)."""

    @staticmethod
    def forward(ctx, x, y, forward_fn):
        dist, idx = forward_fn(x, y)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(x, y, idx)
        return dist, idx

    @staticmethod
    def backward(ctx, g_dist, _g_idx):
        x, y, idx = ctx.saved_tensors
        nearest = y.reshape(-1, 3)[_flat_rows(y, idx)]
        dx = g_dist[..., None] * (2.0 * (x - nearest))
        dy = (scatter_to_cloud(y, idx, -dx) if ctx.needs_input_grad[1]
              else None)
        return dx, dy, None


def nn_distance(x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared distance from each x [..., 3] to its nearest y [M, 3]
    point -> (dist [...] f32, idx [...] int32), differentiable in x and
    y: the kernel for CUDA tensors, the plain version for CPU tensors.
    With clouds y [C, M, 3], x is [C, ..., 3] and clip c searches y[c]."""
    return _NNDistance.apply(x, y, nn_index)


def nn_distance_ref(x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn_distance through the plain version on any device (the
    reference the kernel is held against)."""
    return _NNDistance.apply(x, y, nn_distance_plain)


def chamfer(x: torch.Tensor, y: torch.Tensor):
    """Bidirectional chamfer, the distChamfer 4-tuple
    (chamfer_pallas.chamfer): x [B, N, 3], y [B, M, 3] or a shared
    [M, 3] -> (dist_x [B, N], dist_y [B, M], idx_x, idx_y)."""
    if y.ndim == 2:
        d_xy, i_xy = nn_distance(x, y)
        back = [nn_distance(y, xb) for xb in x]
    else:
        fwd = [nn_distance(xb, yb) for xb, yb in zip(x, y)]
        d_xy = torch.stack([d for d, _ in fwd])
        i_xy = torch.stack([i for _, i in fwd])
        back = [nn_distance(yb, xb) for xb, yb in zip(x, y)]
    d_yx = torch.stack([d for d, _ in back])
    i_yx = torch.stack([i for _, i in back])
    return d_xy, d_yx, i_xy, i_yx
