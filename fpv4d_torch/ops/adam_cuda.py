"""One step of optax's Adam over every leaf in one launch: the
hand-written CUDA kernel of solve/adam.py's ``Adam`` (csrc/adam_step.cu;
it replaces no TPU kernel: XLA fuses the JAX package's optax update).

The kernel reads a ``LeafTable`` built once per ``Adam``: per leaf the
addresses of its parameter, gradient and moments and its element count
(int64 rows, the kernel's ``Leaf``), and per block of the launch its
leaf and first element (``CHUNK`` elements a block). The leaves' tensors
keep their storage for the optimizer's life (the moments and gradients
are updated in place, never replaced), so the table stays true and a
captured step replays with no host work. A ``select`` view of an Adam's
rows (a fleet's clips) gets a table of its own.

The step is the plain route's arithmetic, operation by operation with
no FMA contraction, and it writes each gradient 0 after reading it (the
plain route's ``zero_grad`` is folded into the launch). The kernel is
built with nvcc at first use (``build()``, see ops/cuda_build.py);
importing this module needs no CUDA toolkit. While tracing is on
(utils/observability.py) each launch counts ``adam/cuda``.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from fpv4d_torch.ops import cuda_build
from fpv4d_torch.utils import observability as OBS

SRC = cuda_build.CSRC / "adam_step.cu"
_step = None            # the kernel's C entry point, once built
build_log = ""

# elements a block steps (csrc/adam_step.cu: kThreads x kPerThread)
CHUNK = 512


def build() -> float:
    """Compile (if not already built for this source) and load the
    kernel; returns the seconds it took."""
    global _step, build_log
    if _step is not None:
        return 0.0
    t0 = time.perf_counter()
    ptr, i32, f32 = cuda_build.POINTER, cuda_build.INT, ctypes.c_float
    _step, build_log = cuda_build.load_function(
        SRC, "adam_step", [ptr, ptr, i32, ptr, ptr] + [f32] * 6 + [ptr])
    return time.perf_counter() - t0


def chunk_plan(sizes: Sequence[int]) -> np.ndarray:
    """[n_chunks, 2] int32 (leaf, first element) of CHUNK-element blocks
    over leaves of `sizes` elements, in leaf order; one empty block
    (leaf 0, element 0) when there is no element, since the launch also
    advances the count."""
    rows = [(i, s) for i, n in enumerate(sizes) for s in range(0, n, CHUNK)]
    return np.asarray(rows or [(0, 0)], np.int32).reshape(-1, 2)


@dataclass(frozen=True)
class LeafTable:
    """The kernel's view of one Adam: ``leaves`` [L, 5] int64 (addresses
    of p, g, mu, nu and the element count), ``chunks`` [n_chunks, 2]
    int32, ``ticket`` [1] int32 (0 between launches); ``tensors`` keeps
    every addressed tensor alive."""
    leaves: torch.Tensor
    chunks: torch.Tensor
    ticket: torch.Tensor
    tensors: Tuple[torch.Tensor, ...]


def leaf_table(params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
               nu: Sequence[torch.Tensor]) -> LeafTable:
    """The LeafTable of these leaves (on their device; built on the
    host once per Adam). Each leaf's four tensors are contiguous f32 of
    one shape on one device."""
    dev = params[0].device
    rows = []
    for i, ts in enumerate(zip(params, grads, mu, nu)):
        if any(t.shape != ts[0].shape or t.dtype != torch.float32
               or t.device != dev or not t.is_contiguous() for t in ts):
            raise ValueError(
                f"the Adam kernel takes contiguous f32 leaves, gradients "
                f"and moments of one shape on one device; leaf {i}: "
                f"{[(tuple(t.shape), t.dtype, str(t.device), t.is_contiguous()) for t in ts]}")
        if ts[0].numel() >= 2 ** 31:
            raise ValueError(f"the Adam kernel: leaf {i} exceeds int32 "
                             f"indexing")
        rows.append([t.data_ptr() for t in ts] + [ts[0].numel()])
    return LeafTable(
        leaves=torch.tensor(rows, dtype=torch.int64, device=dev),
        chunks=torch.as_tensor(chunk_plan([r[4] for r in rows]),
                               device=dev),
        ticket=torch.zeros(1, dtype=torch.int32, device=dev),
        tensors=tuple(params) + tuple(grads) + tuple(mu) + tuple(nu))


def step(table: LeafTable, count: torch.Tensor, lr: float, b1: float,
         b2: float, eps: float) -> None:
    """One Adam step of every leaf in `table` (the count advanced by
    one, every gradient left 0) on the current stream."""
    build()
    f32 = ctypes.c_float
    err = _step(table.leaves.data_ptr(), table.chunks.data_ptr(),
                table.chunks.shape[0], count.data_ptr(),
                table.ticket.data_ptr(), f32(b1), f32(1 - b1), f32(b2),
                f32(1 - b2), f32(eps), f32(-lr),
                torch.cuda.current_stream(count.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_step launch failed: CUDA error {err}")
    OBS.count("adam/cuda")
