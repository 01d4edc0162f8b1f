"""Linear blend skinning of SMPL-X vertices: a hand-written CUDA kernel
pair (forward and backward) and its plain PyTorch version.

For frame b and vertex v, with joint transforms A [B, J, 12] (3x4,
row-major), an optional translation transl [B, 3] and posed vertices vp
[B, V, 3]:

    out[b, v] = (sum_j W[v, j] A[b, j]) [vp[b, v]; 1] + transl[b]

Step 5 of ``SmplxModel.forward``. The plain version is the former chain:
``lbs_weights @ A`` writes every vertex's blended 3x4 to memory and a
batched 3x4 by 4x1 product applies it (what the JAX package leaves to
XLA in fpv4d/models/smplx.py). The kernel pair (csrc/lbs_skin.cu; it
replaces no TPU kernel) rebuilds each vertex's 3x4 in registers and
never writes one, nor its gradient; its forward sums in the library
chain's order and gives its bits on an H100. It reads the weights W [V, J] as a
``SkinTable``: each vertex's nonzero joints and weights padded to the
largest row count K (an ELL table), and per joint its vertices and
weights in vertex order for the backward's sums over vertices. Only
exact zeros are left out, so the work and the result are the dense
product's, up to f32 summation order; the sums over vertices run in a
fixed order without atomics, so the kernel gives the same bits from run
to run and in a CUDA graph's replay.

The world transform stays where it was (``clip_solve.forward_world``:
the scale, then ``transform_points``). Folded into the joint transforms
it saves a few more kernels, but its reassociated rounding of the world
vertices moved the full-mesh skate phase's Adam steps away from the
benchmark's reference by up to 5e-4 relative in 2 of 22 local-brute
solves, against 3.5e-5 at most without the fold (PERF.md).

``skin`` takes the plain version for CPU tensors and the kernel for
CUDA tensors (never a fallback). While tracing is on
(utils/observability.py) each launch of the forward or the backward
counts ``skin/cuda`` and each call of ``skin`` on CPU tensors
``skin/plain``. The kernel
is built with nvcc at first use (``build()``, see ops/cuda_build.py);
importing this module needs no CUDA toolkit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from fpv4d_torch.ops import cuda_build
from fpv4d_torch.utils import observability as OBS

SRC = cuda_build.CSRC / "lbs_skin.cu"
_forward = None         # the kernels' C entry points, once built
_backward = None
build_log = ""

# the kernel's limit on joints (J x 48 bytes of shared memory a block)
MAX_JOINTS = 512


def build() -> float:
    """Compile (if not already built for this source) and load the
    kernels; returns the seconds it took."""
    global _forward, _backward, build_log
    if _forward is not None:
        return 0.0
    t0 = time.perf_counter()
    ptr, i32 = cuda_build.POINTER, cuda_build.INT
    fwd, build_log = cuda_build.load_function(
        SRC, "lbs_skin_forward", [ptr] * 6 + [i32] * 4 + [ptr])
    _backward, _ = cuda_build.load_function(
        SRC, "lbs_skin_backward", [ptr] * 11 + [i32] * 4 + [ptr])
    _forward = fwd
    return time.perf_counter() - t0


@dataclass(frozen=True)
class SkinTable:
    """The skinning weights W [V, J] and the kernel's views of them:
    ``ell_j``, ``ell_w`` [K, V] (row v's nonzero joints, ascending, then
    joint 0 at weight 0), ``ptr`` [J + 1], ``vids``, ``vw`` (joint j's
    vertices, ascending, and weights at ptr[j]:ptr[j + 1])."""
    weights: torch.Tensor
    ell_j: torch.Tensor
    ell_w: torch.Tensor
    ptr: torch.Tensor
    vids: torch.Tensor
    vw: torch.Tensor

    @property
    def K(self) -> int:
        return self.ell_j.shape[0]


def skin_table(weights: torch.Tensor) -> SkinTable:
    """The SkinTable of weights [V, J] (built on the host, once per
    table; its tensors on the weights' device)."""
    w = weights.detach().cpu().numpy()
    V, J = w.shape
    nz = w != 0
    rows, cols = np.nonzero(nz)                 # row-major: rows, then joints
    counts = nz.sum(axis=1)
    K = max(1, int(counts.max()) if V else 1)
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    ell_j = np.zeros((K, V), np.int32)
    ell_w = np.zeros((K, V), np.float32)
    ell_j[slot, rows] = cols
    ell_w[slot, rows] = w[rows, cols]
    tcols, trows = np.nonzero(nz.T)             # joints, then vertices
    ptr = np.concatenate([[0], np.cumsum(nz.sum(axis=0))]).astype(np.int32)
    dev = weights.device

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return SkinTable(weights=weights.contiguous(), ell_j=put(ell_j),
                     ell_w=put(ell_w), ptr=put(ptr),
                     vids=put(trows.astype(np.int32)),
                     vw=put(w[trows, tcols].astype(np.float32)))


def skin_plain(A: torch.Tensor, transl: Optional[torch.Tensor],
               v_posed: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain version: A [B, J, 12], transl [B, 3] or None, v_posed
    [B, V, 3], weights [V, J] -> [B, V, 3]: the blended 3x4 of every
    vertex applied to it, then transl."""
    B = v_posed.shape[0]
    Tm = torch.matmul(weights, A).reshape(B, -1, 3, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvpq,bvq->bvp", Tm, v_homo)
    return verts if transl is None else verts + transl[:, None, :]


def _check(A, o, v_posed, table: SkinTable):
    if not (A.is_cuda and v_posed.is_cuda and table.ell_j.is_cuda):
        raise ValueError("the skinning kernel takes CUDA tensors")
    tensors = (A, v_posed) + (() if o is None else (o,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the skinning kernel takes f32 tensors")
    if any(t.device != v_posed.device for t in tensors + (table.ell_j,)):
        raise ValueError("the skinning kernel's tensors lie on one card")
    B = v_posed.shape[0] if v_posed.ndim else 0
    V, J = table.weights.shape
    if (v_posed.shape != (B, V, 3) or A.shape != (B, J, 12)
            or (o is not None and o.shape != (B, 3))):
        raise ValueError(
            f"skinning takes A [B, J, 12], o [B, 3], v_posed [B, V, 3] "
            f"and a table of [V, J]; got A {tuple(A.shape)}, o "
            f"{None if o is None else tuple(o.shape)}, v_posed "
            f"{tuple(v_posed.shape)}, table {tuple(table.weights.shape)}")
    if J > MAX_JOINTS:
        raise ValueError(f"the skinning kernel takes at most {MAX_JOINTS} "
                         f"joints, got {J}")
    if 3 * B * V >= 2 ** 31 or 12 * B * J >= 2 ** 31:
        raise ValueError("the skinning kernel: tensors exceed int32 "
                         "indexing")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def skin_cuda_forward(A: torch.Tensor, o: Optional[torch.Tensor],
                      v_posed: torch.Tensor, table: SkinTable
                      ) -> torch.Tensor:
    """The forward kernel (no gradient): A [B, J, 12], o (transl) [B, 3]
    or None, v_posed [B, V, 3] -> [B, V, 3]."""
    _check(A, o, v_posed, table)
    B, V = v_posed.shape[:2]
    out = torch.empty_like(v_posed, memory_format=torch.contiguous_format)
    build()
    A, v_posed = A.contiguous(), v_posed.contiguous()
    o = None if o is None else o.contiguous()
    err = _forward(A.data_ptr(), _ptr(o), v_posed.data_ptr(),
                   table.ell_j.data_ptr(), table.ell_w.data_ptr(),
                   out.data_ptr(), B, V, A.shape[1], table.K,
                   torch.cuda.current_stream(v_posed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbs_skin forward launch failed: CUDA error "
                           f"{err}")
    OBS.count("skin/cuda")
    return out


def skin_cuda_backward(A: torch.Tensor, v_posed: torch.Tensor,
                       g: torch.Tensor, table: SkinTable, need_points: bool,
                       need_joints: bool, need_offset: bool):
    """The backward kernels: (d v_posed, d A, d o) given g = d out, each
    None unless asked for."""
    _check(A, None, v_posed, table)
    B, V = v_posed.shape[:2]
    J = A.shape[1]
    dvp = (torch.empty_like(v_posed, memory_format=torch.contiguous_format)
           if need_points else None)
    dA = A.new_empty(B, J, 12) if need_joints else None
    dO = v_posed.new_empty(B, 3) if need_offset else None
    if dvp is None and dA is None and dO is None:
        return None, None, None
    build()
    A, v_posed, g = A.contiguous(), v_posed.contiguous(), g.contiguous()
    err = _backward(A.data_ptr(), v_posed.data_ptr(), g.data_ptr(),
                    table.ell_j.data_ptr(), table.ell_w.data_ptr(),
                    table.ptr.data_ptr(), table.vids.data_ptr(),
                    table.vw.data_ptr(), _ptr(dvp), _ptr(dA), _ptr(dO),
                    B, V, J, table.K,
                    torch.cuda.current_stream(v_posed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbs_skin backward launch failed: CUDA error "
                           f"{err}")
    OBS.count("skin/cuda")
    return dvp, dA, dO


class _Skin(torch.autograd.Function):
    """skin_cuda_forward, with the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, A, o, v_posed, table):
        ctx.table = table
        ctx.has_offset = o is not None
        ctx.save_for_backward(A, v_posed)
        return skin_cuda_forward(A, o, v_posed, table)

    @staticmethod
    def backward(ctx, g):
        A, v_posed = ctx.saved_tensors
        need = ctx.needs_input_grad
        dvp, dA, dO = skin_cuda_backward(
            A, v_posed, g, ctx.table, need_points=need[2],
            need_joints=need[0], need_offset=ctx.has_offset and need[1])
        return dA, dO, dvp, None


def skin(A: torch.Tensor, transl: Optional[torch.Tensor],
         v_posed: torch.Tensor, table: SkinTable) -> torch.Tensor:
    """skin_plain's vertices [B, V, 3] through table's weights,
    differentiable in A, transl and v_posed: the kernel pair for CUDA
    tensors, the plain version for CPU tensors."""
    if v_posed.is_cuda or A.is_cuda:
        return _Skin.apply(A, transl, v_posed, table)
    OBS.count("skin/plain")
    return skin_plain(A, transl, v_posed, table.weights)
