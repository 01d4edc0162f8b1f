"""Per-step contact nearest-neighbour: hand-written CUDA kernel K1 and
its plain PyTorch version.

Replaces the TPU kernel ``_cand_kernel`` of fpv4d/ops/cand_pallas.py
(launched from ``_forward``, public entry ``cand_nn``) and serves the
f32 ``nn_to_candidates`` contract of fpv4d/ops/nn.py: for each frame t
and query q[t, n], the nearest of the frame's P candidates, where
invalid slots count as 1e4 and ties go to the smallest slot; the output
distance is min(d, 1e4), and ``nearest`` is the winner's coordinates,
or q itself where the distance saturates. The gradient is
2 (q - nearest) g where dist < 1e4, and 0 elsewhere.

The TPU kernel selects with a bf16x3 Gram form and a packed-index
int-min, whose winners can differ from exact differences among
near-ties. The kernel here (csrc/cand_nn.cu) runs the same folded
product on the tensor cores through the tile routine it shares with K2
(csrc/gram_nn.cuh), but only as a filter: every candidate that comes
within a proven margin of a query's best is re-evaluated in the
difference form, unfused, and a query whose best is 1e4 or more rescans
its slots exactly with the 1e4 rule. It is then bit-identical to
``cand_nn_plain`` on the card. ``filter_emulated`` repeats the filter in
plain PyTorch (ops/gram_nn.py) for the CPU tests.

While tracing is on (utils/observability.py) each launch of the kernel
counts ``k1/cuda`` and each call of ``cand_nn`` on CPU tensors
``k1/plain``.

The kernel is built with nvcc at first use (``build()``, see
ops/cuda_build.py) from the source in the repository into
``fpv4d_torch/_build/`` (git-ignored) as a shared library with a plain C
interface, loaded with ctypes. Only the function that launches it needs
the CUDA toolkit; importing this module does not.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from fpv4d_torch.ops import cuda_build, gram_nn
from fpv4d_torch.utils import observability as OBS

BIG = 1e4

# queries of a frame per block of the kernel, centred on the first
BLOCK_QUERIES = 128

SRC = cuda_build.CSRC / "cand_nn.cu"
_launch = None          # the kernel's C entry point, once built
build_log = ""


def build() -> float:
    """Compile (if not already built for this source) and load the
    kernel; returns the seconds it took."""
    global _launch, build_log
    if _launch is not None:
        return 0.0
    t0 = time.perf_counter()
    ptr, i32 = cuda_build.POINTER, cuda_build.INT
    _launch, build_log = cuda_build.load_function(
        SRC, "cand_nn_forward", [ptr] * 7 + [i32] * 3 + [ptr])
    return time.perf_counter() - t0


def dist_sq_tnp(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Squared distances [T, N, P] with the xyz axis unrolled into three
    elementwise terms, summed (dx*dx + dy*dy) + dz*dz (the reference's
    order, nn.py:506-519)."""
    dx = q[:, :, None, 0] - cand[:, None, :, 0]
    dy = q[:, :, None, 1] - cand[:, None, :, 1]
    dz = q[:, :, None, 2] - cand[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _empty(q: torch.Tensor):
    T, N, _ = q.shape
    return (torch.full((T, N), BIG, dtype=q.dtype, device=q.device),
            torch.zeros((T, N), dtype=torch.int32, device=q.device),
            q.clone())


def cand_nn_plain(q: torch.Tensor, cand: torch.Tensor,
                  valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: q [T,N,3], cand [T,P,3], valid [T,P]
    -> (dist [T,N] f32, slot [T,N] int32, nearest [T,N,3] f32)."""
    if cand.shape[1] == 0:
        return _empty(q)
    d = torch.where(valid[:, None, :], dist_sq_tnp(q, cand), BIG)
    dmin, slot = torch.min(d, dim=-1)      # ties -> the smallest slot
    dist = torch.clamp(dmin, max=BIG)
    near = torch.gather(cand, 1, slot[..., None].expand(-1, -1, 3))
    nearest = torch.where((dist < BIG)[..., None], near, q)
    return dist, slot.to(torch.int32), nearest


def cand_nn_cuda(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
                 rechecks: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on the card; same contract as cand_nn_plain. Raises on
    anything the kernel does not take. `rechecks`, an int32 [T, N]
    tensor on the same card, receives each query's number of exact
    evaluations (the solve path passes none)."""
    if not (q.is_cuda and cand.is_cuda and valid.is_cuda):
        raise ValueError("cand_nn_cuda takes CUDA tensors")
    if q.dtype != torch.float32 or cand.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise ValueError("cand_nn_cuda takes f32 q/cand and bool valid")
    T, N, c3 = q.shape
    if c3 != 3 or cand.shape[0] != T or cand.shape[2] != 3 \
            or tuple(valid.shape) != tuple(cand.shape[:2]):
        raise ValueError(f"shapes q {tuple(q.shape)}, cand "
                         f"{tuple(cand.shape)}, valid {tuple(valid.shape)}")
    if T * N * 3 >= 2 ** 31 or T * cand.shape[1] * 3 >= 2 ** 31:
        raise ValueError("cand_nn_cuda: tensors exceed int32 indexing")
    P = cand.shape[1]
    if rechecks is not None and (
            rechecks.dtype != torch.int32 or rechecks.device != q.device
            or tuple(rechecks.shape) != (T, N)
            or not rechecks.is_contiguous()):
        raise ValueError("rechecks must be a contiguous int32 [T, N] "
                         "tensor on the queries' device")
    if P == 0 or T == 0 or N == 0:
        return _empty(q)
    build()
    q, cand, valid = q.contiguous(), cand.contiguous(), valid.contiguous()
    dist = torch.empty((T, N), dtype=torch.float32, device=q.device)
    slot = torch.empty((T, N), dtype=torch.int32, device=q.device)
    nearest = torch.empty((T, N, 3), dtype=torch.float32, device=q.device)
    err = _launch(
        q.data_ptr(), cand.data_ptr(), valid.data_ptr(), dist.data_ptr(),
        slot.data_ptr(), nearest.data_ptr(),
        0 if rechecks is None else rechecks.data_ptr(), T, N, P,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cand_nn kernel launch failed: CUDA error {err}")
    OBS.count("k1/cuda")
    return dist, slot, nearest


def filter_emulated(q: torch.Tensor, cand: torch.Tensor,
                    valid: torch.Tensor, kind: str = "bf16"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's filter in plain PyTorch, per frame and block of
    BLOCK_QUERIES queries centred as the kernel centres them: (whether
    each query's exact winner and ties pass the filter at the winner's
    distance [T, N] bool, True where that distance is 1e4 or more and
    the kernel rescans instead; how many slots pass there [T, N], 0
    there)."""
    T, N, _ = q.shape
    d = torch.where(valid[:, None, :], dist_sq_tnp(q, cand), BIG)
    hit = d.min(-1).values < BIG
    won = torch.ones((T, N), dtype=torch.bool)
    passes = torch.zeros((T, N), dtype=torch.int64)
    for t in range(T):
        for s in range(0, N, BLOCK_QUERIES):
            e = min(N, s + BLOCK_QUERIES)
            w, n = gram_nn.block_passes(q[t, s:e], cand[t], d[t, s:e],
                                        valid[t], kind)
            won[t, s:e] = w | ~hit[t, s:e]
            passes[t, s:e] = torch.where(hit[t, s:e], n, 0)
    return won, passes


def cand_nn(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor):
    """Dispatch on the tensors' device: the plain version for CPU
    tensors, the kernel for CUDA tensors (never a fallback)."""
    if q.is_cuda:
        return cand_nn_cuda(q, cand, valid)
    OBS.count("k1/plain")
    return cand_nn_plain(q, cand, valid)


class _CandNN(torch.autograd.Function):
    """dist [T,N] with the gradient 2 (q - nearest) g on live entries
    (dist < BIG); no gradient to the candidate tables."""

    @staticmethod
    def forward(ctx, q, cand, valid, forward_fn):
        dist, _, nearest = forward_fn(q, cand, valid)
        ctx.save_for_backward(q, nearest, dist < BIG)
        return dist

    @staticmethod
    def backward(ctx, g):
        q, nearest, live = ctx.saved_tensors
        dq = torch.where(live[..., None],
                         g[..., None] * 2.0 * (q - nearest), 0.0)
        return dq, None, None, None


def nn_to_candidates(q: torch.Tensor, cand: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Differentiable squared NN distance [T, N] to per-frame candidates:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    return _CandNN.apply(q, cand, valid, cand_nn)


def nn_to_candidates_ref(q: torch.Tensor, cand: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """nn_to_candidates through the plain version on any device (the
    reference the kernel is held against)."""
    return _CandNN.apply(q, cand, valid, cand_nn_plain)
