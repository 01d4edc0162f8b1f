"""What one step of the clip solve costs, counted from shapes, and the
card's peaks, bounds and timing helper that measurements are held
against (``python -m fpv4d_torch.bench`` and ``chip_smoke.py``).

``step_cost`` gives one optimizer step of a phase as (FLOPs, bytes):

* FLOPs: the matmul-class operations (mm, bmm, addmm, convolutions;
  ``torch.utils.flop_counter.FlopCounterMode``, which counts no
  elementwise op) of one forward of the phase's loss and its gradient,
  with the FK on ``fk.rigid_transform_ref`` whatever route production
  takes, plus the contact nearest-neighbour search at FLOPS_PER_PAIR
  per (query, point) pair of its shapes. The search itself is left out
  of the counted run (a launch through ctypes is invisible to the
  counter, a plain version would be counted by its ops), so the count
  is the same whichever route computes it.
* bytes: each tensor the step reads counted once and each tensor it
  writes counted once (the on-card rule of a roofline bound): the four
  state leaves read and written, their gradients written, both Adam
  moments read and written, and every other tensor that exists before
  the step and is read by it (the model's tables on the phase's vertex
  subset, the VPoser weights, the target and frame weights), plus the
  contact search's tables (candidate tables, voxel grid or scene).
  Intermediates are not counted: this is not XLA's "bytes accessed",
  which counts every fusion's operands and so can exceed the traffic
  the card must move.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from fpv4d_torch.models import fk
from fpv4d_torch.solve.clip_solve import ClipSolver, ClipState, masked

# NVIDIA H100 SXM data sheet (dense rates, at the 700 W power limit):
# 67 TFLOP/s in f32 outside the tensor cores (the port runs f32 with
# TF32 off, so FLOP shares are taken against it) and 3.35 TB/s of HBM
PEAK_F32_FLOPS = 67e12
HBM_BPS = 3.35e12
# CUDA-core lane instructions/s, 132 SMs x 128 lanes x 1.98 GHz boost
LANE_OPS = 132 * 128 * 1.98e9

# f32 operations of one (query, point) distance: 3 subtracts, 3
# multiplies, 2 adds
FLOPS_PER_PAIR = 8


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / LANE_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# The least work of a nearest-neighbour search, whatever unit does it:
# the Gram product can go to the tensor cores, but the running minimum
# needs at least one CUDA-core instruction per pair. (The 67 TFLOP/s f32
# peak counts an FMA as two operations, and no unit has to do the
# difference form's 8 f32 operations per pair.)


def k1_bound_ms(T: int, N: int, P: int):
    """Least time for K1's work: each input read once, each output
    written once, and one CUDA-core instruction per (query, candidate)
    pair."""
    nbytes = (T * N * 3 * 4 + T * P * 3 * 4 + T * P      # q, cand, valid
              + T * N * 4 + T * N * 4 + T * N * 3 * 4)   # dist, slot, near
    return bound_ms(nbytes, float(T * N * P))


def k2_bound_ms(Q: int, M: int, clips: int = 1):
    """Least time for K2's work, counted as for K1: x and y read once,
    dist and idx written once, one instruction per (query, point); with
    a clip axis, each of `clips` clips has Q queries and an M-point
    cloud (padding included: the function searches it)."""
    return bound_ms(clips * (Q * 3 * 4 + M * 3 * 4 + Q * 4 + Q * 4),
                    float(clips * Q * M))


def _live_storages() -> set:
    """Storage addresses of every strided tensor alive now."""
    return {o.untyped_storage().data_ptr() for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor)
            and o.layout == torch.strided}


class _PriorReads(TorchDispatchMode):
    """The bytes of the tensors that ops read from storages in `prior`
    (tensors alive before the window) and not in `skip`, each storage
    counted once, at the largest view of it read."""

    def __init__(self, prior: set, skip=()):
        super().__init__()
        self.prior = prior - set(skip)
        self.read: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in pytree.tree_leaves((args, kwargs or {})):
            if isinstance(t, torch.Tensor):
                key = t.untyped_storage().data_ptr()
                if key in self.prior:
                    self.read[key] = max(self.read.get(key, 0), t.nbytes)
        return func(*args, **(kwargs or {}))

    @property
    def nbytes(self) -> int:
        return sum(self.read.values())


def matmul_flops(loss_fn: Callable[[], torch.Tensor],
                 inputs: Sequence[torch.Tensor]) -> int:
    """Matmul-class FLOPs of loss_fn() and its gradient with respect to
    `inputs` (FlopCounterMode's count); an input the loss does not
    reach adds nothing."""
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(loss_fn(), list(inputs), allow_unused=True)
    return int(fc.get_total_flops())


@contextlib.contextmanager
def _contact_stub(solver: ClipSolver, pairs: list, tables: dict):
    """solver._nn replaced by a zero distance that keeps the graph; each
    call appends its (query, point) pairs to `pairs` and puts the bytes
    of the tables it searches in `tables`, by storage."""
    def nn(pts, cands=None):
        q = int(np.prod(pts.shape[:-1]))
        if cands is not None:
            ts, n = (cands.cand, cands.valid), cands.cand.shape[-2]
        elif solver.nn_impl == "grid":
            g = solver.grid
            ts, n = (g.cand_pts, g.cand_idx, g.origin), g.cand_pts.shape[-2]
        else:
            ts, n = (solver.scene,), solver.scene.shape[0]
        pairs.append(q * n)
        tables.update((t.untyped_storage().data_ptr(), t.nbytes)
                      for t in ts)
        return (pts * 0.0).sum(-1)

    solver._nn = nn
    try:
        yield
    finally:
        del solver._nn


def step_cost(solver: ClipSolver, phase: str, state: ClipState,
              target_6d: torch.Tensor, frame_weights: torch.Tensor,
              cands=None, weight_right: Optional[torch.Tensor] = None
              ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one optimizer step of `phase` ('local_a',
    'local_b', 'global_a', 'global_b', 'dct_a', 'dct_b' or 'skate') at
    `state`'s shapes: contact against `cands` (the lazy tables) when
    given, else the solver's per-step source (the exact grid query or
    the whole scene). dct_a is its hoisted step, the DCT residual on
    joints computed once per phase (that forward is not counted); skate
    needs `weight_right`. Nothing of the state or the optimizer is
    changed, and no kernel is launched."""
    leaves = [x.detach().requires_grad_(True) for x in state]
    st = masked(ClipState(*leaves), solver.phase_mask(phase))
    if phase == "dct_a":
        joints_w = solver.hoisted_joints(state)

        def loss_fn():
            return solver.dct_a_loss(joints_w, st)
    elif phase == "skate":
        def loss_fn():
            return solver.skate_loss(st, target_6d, frame_weights,
                                     weight_right)
    else:
        def loss_fn():
            return solver.phase_loss(phase, st, target_6d, frame_weights,
                                     cands)
    wrt = [x for x in st if x.requires_grad]
    pairs: list = []
    tables: dict = {}
    leaf_ptrs = [x.untyped_storage().data_ptr() for x in state]
    prod, fk.rigid_transform_prod = (fk.rigid_transform_prod,
                                     fk.rigid_transform_ref)
    try:
        with _contact_stub(solver, pairs, tables):
            with torch.no_grad():
                loss_fn()         # builds the model's per-subset tables
            pairs.clear()
            with _PriorReads(_live_storages(), skip=leaf_ptrs) as reads:
                flops = matmul_flops(loss_fn, wrt)
    finally:
        fk.rigid_transform_prod = prod
    flops += FLOPS_PER_PAIR * sum(pairs)
    # Adam: each leaf read and written, its gradient written, both
    # moments read and written
    leaf_bytes = sum(x.nbytes for x in state)
    nbytes = reads.nbytes + 7 * leaf_bytes + sum(tables.values())
    return float(flops), float(nbytes)
