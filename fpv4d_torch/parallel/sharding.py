"""The clips and frames axes of a fleet solve (port of
fpv4d/parallel/sharding.py).

The reference jits each phase of a batched fleet over a device mesh
with (clips x frames) shardings and lets XLA insert the collectives. The
port has no mesh compiler, so it splits the work in three:

  * **One rank's clips run as one fold.** The per-phase functions below
    (``run_phase``: the reference's build_sharded_step; ``refresh_sdf``,
    ``refresh_cands`` and ``detect_contact``: its sdf-refresh, refresh
    and detect-contact programs) fold the clips axis into frames for the
    model chain (``flatten_state``), reshape the outputs to [C, T, ...]
    and take every loss term per clip with ``torch.vmap`` of the
    single-clip term: each term is a mean over its own clip, and no
    difference in time and no DCT window crosses a clip boundary. The
    contact distance goes through K1 on the folded tables [C*T, N, P]
    (one launch for the fleet), the folded exact grid query, or K2 over
    the clips' padded scenes (one launch).
  * **A clips axis of R ranks** (``torch.distributed``; NCCL on the card,
    gloo on the CPU) gives each rank a contiguous C/R of the clips; each
    rank solves its own with the fold, and ``all_gather_clips`` gives
    every rank every clip's results. Clips never interact.
  * **A frames axis of F ranks** gives each rank the contiguous frames
    [f T/F, (f+1) T/F) of its clips (``FrameShard``), with the
    collectives written by hand, each inside the frames group of the
    rank's clip row:
      - a halo (``FrameShard.halo``): the right neighbour's first 2
        frames of body_6d and camera_ext, gathered in the forward; the
        model chain runs on the rank's frames plus the halo, so the
        +-2-frame differences (second-order smoothness, first-order
        joint smoothness, foot skate) that start on the rank are its
        own. The backward gathers the halo rows' gradient and hands it
        to their owner, which adds it to its first 2 rows;
      - per-clip means: each rank's term is the sum over its own frames
        (or differences, windows) divided by the clip's global count, so
        the clip's loss is the sum of its ranks' partials, all-reduced
        once per phase for the history only;
      - whole leaves: ``scale`` always, and ``c_dct`` unless the window
        count W divides over F (``window_range``, the reference's
        clip_batch_shardings rule). Each rank holds a copy; their
        gradients are all-reduced (summed) over the frames group before
        each Adam step, so every copy moves identically;
      - the DCT term: local on whole windows when W % F == 0; otherwise
        the joint trajectory is gathered over the frames group (the
        backward keeps each rank's own frames: every rank computes the
        same whole term, and only the rank at frames coordinate 0 counts
        its value and its c_dct gradient).
    Per-frame work (refresh and compaction, the SDF linearization, the
    contact detection, the contact NN) needs no collective.

A frames rank's step is cut at its collectives (``run_phase``): the
halo's gather, the rank's own terms (the segment "own"), for dct_b with
a whole c_dct the joints' gather and the DCT term with the loss's sum
(the segment "dct"), the backward through them (the halo's gather of
gradients last), the gradient sum, the Adam step. The segments and the
Adam step go through the phase program (solve/step_graph.py
``PhaseProgram.segment`` and ``call``: on the card each captured once
per phase and replayed), the collectives run eagerly between the
replays; the eager route runs the same pieces eagerly, so the two give
the same bits.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fpv4d_torch.ops import losses
from fpv4d_torch.ops import nn as NN
from fpv4d_torch.ops import sdf as SDF
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.adam import Adam
from fpv4d_torch.solve.clip_solve import (ClipSolver, ClipState,
                                          forward_world, stage_contact)

# frames of the right neighbour a rank needs: the second-order
# differences reach t + 2
HALO = 2


# -- process group and mesh ---------------------------------------------------

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 device="cuda",
                                 backend: Optional[str] = None) -> bool:
    """Join a process group, gated so single-process runs are a strict
    no-op: active when FPV4D_DISTRIBUTED=1 (rank, world size and address
    then come from torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) or when an `init_method` is given. The backend is
    NCCL for a CUDA `device` (each rank on the card of its LOCAL_RANK
    unless the device names one) and gloo for the CPU, unless `backend`
    names one: gloo lets several ranks share one card, which NCCL
    refuses. Returns True if a process group is (or already was)
    initialized."""
    if init_method is None and os.environ.get("FPV4D_DISTRIBUTED") != "1":
        return False
    if dist.is_initialized():
        return True
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    kw = {k: v for k, v in (("world_size", world_size), ("rank", rank))
          if v is not None}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", **kw)
    return True


@dataclass(frozen=True)
class Mesh:
    """Named axes over the first `size` ranks of the process group (one
    rank when there is none), laid out row-major in the order the axes
    are given (rank = c F + f on {'clips': R, 'frames': F}), as the
    reference reshapes its device list; this process's rank; and the
    process group of each axis line through it (None on a one-rank
    axis, or without a process group)."""
    axes: Dict[str, int]
    rank: int = 0
    groups: Dict[str, Any] = field(default_factory=dict, compare=False,
                                   repr=False)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.axes.values()), dtype=np.int64))

    @property
    def member(self) -> bool:
        """False for a rank beyond the mesh's (it solves nothing)."""
        return self.rank < self.size

    def coord(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 on an axis the mesh
        lacks)."""
        if axis not in self.axes:
            return 0
        names = list(self.axes)
        return int(np.unravel_index(self.rank, tuple(self.axes.values()))
                   [names.index(axis)])


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A mesh such as {'clips': 2, 'frames': 4} over the first prod(axes)
    ranks of the process group (ranks beyond it are not members). Every
    rank creates every axis line's process group, in the same order.
    Raises ValueError for an axis below 1 and when the process group (1
    rank without one) has fewer ranks than the mesh."""
    axes = {str(k): int(v) for k, v in axes.items()}
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    n = int(np.prod(list(axes.values()), dtype=np.int64))
    if n > world_size():
        raise ValueError(f"mesh {axes} needs {n} ranks, the process group "
                         f"has {world_size()}")
    groups = {}
    if dist.is_initialized():
        grid = np.arange(n).reshape(tuple(axes.values()))
        for i, (name, size) in enumerate(axes.items()):
            if size == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, size):
                ranks = [int(r) for r in line]
                g = (dist.group.WORLD if len(ranks) == world_size()
                     else dist.new_group(ranks))
                if rank() in ranks:
                    groups[name] = g
    return Mesh(axes, rank(), groups)


def clip_range(mesh: Mesh, num_clips: int,
               clip_axis: str = "clips") -> Tuple[int, int]:
    """This rank's contiguous clips [start, stop) of num_clips: a clips
    axis of R ranks gives each num_clips / R (R must divide it), by the
    rank's coordinate on that axis."""
    R = mesh.axes.get(clip_axis, 1)
    if num_clips % R:
        raise ValueError(f"{num_clips} clips do not split over a clips axis "
                         f"of {R} ranks")
    n = num_clips // R
    c = mesh.coord(clip_axis)
    return c * n, (c + 1) * n


def frame_range(mesh: Mesh, T: int,
                frame_axis: str = "frames") -> Tuple[int, int]:
    """This rank's contiguous frames [f T/F, (f+1) T/F) of a T-frame clip
    on a frames axis of F ranks. Raises ValueError when F does not divide
    T, or when a rank would hold fewer than 2 frames (the halo of the
    second-order differences must come from one neighbour)."""
    F = mesh.axes.get(frame_axis, 1)
    if T % F:
        raise ValueError(f"{T} frames do not split over a frames axis of "
                         f"{F} ranks")
    n = T // F
    if F > 1 and n < HALO:
        raise ValueError(f"{T} frames over a frames axis of {F} ranks "
                         f"leave {n} per rank; each needs >= {HALO}")
    f = mesh.coord(frame_axis)
    return f * n, (f + 1) * n


def window_range(mesh: Mesh, num_windows: int,
                 frame_axis: str = "frames") -> Optional[Tuple[int, int]]:
    """This rank's DCT windows [start, stop) when the window count divides
    over the frames axis (c_dct then splits on windows, as the frames
    do); None when it does not (c_dct is whole on every rank) — the
    reference's clip_batch_shardings rule for c_dct."""
    F = mesh.axes.get(frame_axis, 1)
    if num_windows % F:
        return None
    n = num_windows // F
    f = mesh.coord(frame_axis)
    return f * n, (f + 1) * n


def all_gather_axis(x: torch.Tensor, mesh: Mesh, axis: str,
                    dim: int = 0) -> torch.Tensor:
    """Every rank's x on the line of `axis` through this rank,
    concatenated in coordinate order along `dim` (x itself when the axis
    has one rank)."""
    n = mesh.axes.get(axis, 1)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.cat(parts, dim=dim)


def all_gather_clips(x: torch.Tensor, mesh: Mesh, dim: int = 0,
                     clip_axis: str = "clips") -> torch.Tensor:
    """Every rank's part of a clip-axis tensor, concatenated in clips
    coordinate order along `dim` (x itself on a one-rank clips axis)."""
    return all_gather_axis(x, mesh, clip_axis, dim)


# -- the frames axis ----------------------------------------------------------

class _HaloExtend(torch.autograd.Function):
    """[C, L, ...] tensors -> [C, L + h, ...]: each with the first h rows
    of the next rank on the frames axis appended (h = 0 on the last).
    The forward gathers every rank's first HALO rows, packed into one
    tensor; the backward gathers the halo rows' gradients, packed alike,
    and adds the left neighbour's to this rank's first rows. Every rank
    of the line takes part in both, the last with an empty halo."""

    @staticmethod
    def forward(ctx, shard, *xs):
        ctx.shard = shard
        C = xs[0].shape[0]
        ctx.widths = [int(np.prod(x.shape[2:], dtype=np.int64)) * HALO
                      for x in xs]
        head = torch.cat([x[:, :HALO].reshape(C, -1) for x in xs], 1)
        parts = shard.gather(head)
        h = shard.halo_rows
        out = []
        if h:
            nxt = parts[shard.f + 1]
            for x, piece in zip(xs, torch.split(nxt, ctx.widths, 1)):
                out.append(torch.cat([x, piece.reshape(
                    (C, HALO) + x.shape[2:])[:, :h]], 1))
        else:
            out = [x.clone() for x in xs]
        for need, o in zip(ctx.needs_input_grad[1:], out):
            if not need:
                ctx.mark_non_differentiable(o)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        shard = ctx.shard
        C, L = gs[0].shape[0], shard.L
        h = shard.halo_rows
        halo_g = []
        for g, width in zip(gs, ctx.widths):
            pad = torch.zeros((C, HALO) + g.shape[2:], dtype=g.dtype,
                              device=g.device)
            pad[:, :h] = g[:, L:]
            halo_g.append(pad.reshape(C, width))
        parts = shard.gather(torch.cat(halo_g, 1))
        grads = [g[:, :L].clone() for g in gs]
        if shard.f > 0:
            prev = torch.split(parts[shard.f - 1], ctx.widths, 1)
            for g, piece in zip(grads, prev):
                g[:, :HALO] += piece.reshape((C, HALO) + g.shape[2:])
        return (None,) + tuple(g if need else None for g, need in zip(
            grads, ctx.needs_input_grad[1:]))


class _GatherFrames(torch.autograd.Function):
    """[C, L, ...] -> the whole clip [C, T, ...], gathered over the
    frames axis. The backward keeps this rank's own rows: every rank
    computes the same whole-clip term from the gathered tensor, so its
    gradient for the rank's frames is already whole (no collective)."""

    @staticmethod
    def forward(ctx, shard, x):
        ctx.shard = shard
        return torch.cat(shard.gather(x), 1)

    @staticmethod
    def backward(ctx, g):
        return None, g[:, ctx.shard.lo:ctx.shard.hi]


@dataclass(frozen=True)
class FrameShard:
    """This rank's frames [lo, hi) of every one of its clips' T frames
    on the frames axis of a mesh (the whole clip without one, F = 1), and
    its windows [w_lo, w_hi) of the W DCT windows when c_dct splits on
    them (dct_split; otherwise c_dct is whole)."""
    T: int
    lo: int
    hi: int
    F: int = 1
    f: int = 0
    group: Any = None
    W: int = 0
    w_lo: int = 0
    w_hi: int = 0
    dct_split: bool = False

    @classmethod
    def whole(cls, T: int) -> "FrameShard":
        return cls(T=T, lo=0, hi=T)

    @classmethod
    def of(cls, mesh: Mesh, T: int, window: int,
           frame_axis: Optional[str] = "frames") -> "FrameShard":
        if not frame_axis or mesh.axes.get(frame_axis, 1) == 1:
            return cls.whole(T)
        W = T // window
        lo, hi = frame_range(mesh, T, frame_axis)
        wr = window_range(mesh, W, frame_axis)
        return cls(T=T, lo=lo, hi=hi, F=mesh.axes[frame_axis],
                   f=mesh.coord(frame_axis), group=mesh.groups[frame_axis],
                   W=W, w_lo=wr[0] if wr else 0, w_hi=wr[1] if wr else W,
                   dct_split=wr is not None)

    @property
    def L(self) -> int:
        return self.hi - self.lo

    @property
    def halo_rows(self) -> int:
        """Rows of the right neighbour this rank appends (0 on the last)."""
        return min(HALO, self.T - self.hi)

    def ext(self, k: int) -> int:
        """Frames of the rank's own frames plus up to k halo rows."""
        return min(self.hi + k, self.T) - self.lo

    def frac(self, k: int) -> float:
        """The share of a clip's k-th order differences that start on this
        rank: a term's mean over them, times this, is the rank's part of
        the clip's mean (k = 0: frames)."""
        if self.F == 1:
            return 1.0
        return (self.ext(k) - k) / (self.T - k)

    @property
    def whole_leaves(self) -> ClipState:
        """Which leaves each rank holds whole (a copy of the clip's)."""
        return ClipState(body_6d=False, scale=True, camera_ext=False,
                         c_dct=not self.dct_split)

    def gather(self, x: torch.Tensor):
        """Every frames rank's x, in frames order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.F)]
        dist.all_gather(parts, x, group=self.group)
        return parts

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the frames ranks, in place (x itself when F=1)."""
        if self.F > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def halo(self, *xs: torch.Tensor):
        """[C, L, ...] tensors, each with the next rank's first 2 frames
        appended (differentiable; the tensors themselves when F=1)."""
        if self.F == 1:
            return xs
        return _HaloExtend.apply(self, *xs)

    def scaled(self, term: torch.Tensor, k: int) -> torch.Tensor:
        """A per-clip mean over this rank's k-th order differences (k = 0:
        frames) as its part of the clip's mean. Where none starts here
        (the last rank of 2 frames has no second-order difference) the
        mean of none is NaN, and the part is 0, kept in the graph: the
        halo's backward is a collective that every rank must reach."""
        f = self.frac(k)
        if f == 0.0:
            return torch.nan_to_num(term, nan=0.0) * 0.0
        return term if f == 1.0 else term * f

    @property
    def gathers(self) -> bool:
        """Whether the DCT term reads the whole clip's joints, gathered
        over the frames ranks (c_dct whole on a frames axis)."""
        return self.F > 1 and not self.dct_split

    def dct_joints(self, joints_b: torch.Tensor) -> torch.Tensor:
        """The rank's joints [C, L, J, 3] as the DCT term reads them: its
        own frames when c_dct splits on windows, else the whole clip."""
        if not self.gathers:
            return joints_b
        return _GatherFrames.apply(self, joints_b)

    def dct_loss(self, joints_b: torch.Tensor, c_dct_b: torch.Tensor,
                 window: int) -> torch.Tensor:
        """The rank's part [C] of each clip's DCT trajectory term, from
        dct_joints: its windows' share when they are its own; else the
        whole term, whose value (and c_dct gradient) only the rank at
        frames coordinate 0 counts, while every rank keeps the joints
        gradient of its own frames."""
        dct = torch.vmap(lambda j, c: losses.dct_trajectory(j, c, window))
        if self.F == 1:
            return dct(joints_b, c_dct_b)
        if self.dct_split:
            return dct(joints_b, c_dct_b) * ((self.w_hi - self.w_lo)
                                             / self.W)
        if self.f == 0:
            return dct(joints_b, c_dct_b)
        term = dct(joints_b, c_dct_b.detach())
        return term - term.detach()

    def reduce_grads(self, state: ClipState, mask: ClipState):
        """Sum the gradients of the whole leaves the phase optimizes over
        the frames ranks (one packed all-reduce), so every copy's Adam
        step is the same."""
        leaves = [p for p, m, w in zip(state, mask, self.whole_leaves)
                  if m and w]
        if self.F == 1 or not leaves:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in leaves])
        dist.all_reduce(flat, group=self.group)
        for p, g in zip(leaves, torch.split(flat, [p.numel()
                                                   for p in leaves])):
            p.grad.copy_(g.reshape(p.shape))

    def split_state(self, state_b: ClipState) -> ClipState:
        """A whole-clip batched state -> this rank's part of it."""
        c_dct = state_b.c_dct
        if self.dct_split:
            c_dct = c_dct[:, self.w_lo:self.w_hi]
        return ClipState(body_6d=state_b.body_6d[:, self.lo:self.hi],
                         scale=state_b.scale,
                         camera_ext=state_b.camera_ext[:, self.lo:self.hi],
                         c_dct=c_dct)

    def join_state(self, state_b: ClipState) -> ClipState:
        """This rank's part of a batched state -> the whole clips', on
        every frames rank (the whole leaves are this rank's copy)."""
        if self.F == 1:
            return state_b
        return ClipState(
            body_6d=torch.cat(self.gather(state_b.body_6d), 1),
            scale=state_b.scale,
            camera_ext=torch.cat(self.gather(state_b.camera_ext), 1),
            c_dct=(torch.cat(self.gather(state_b.c_dct), 1)
                   if self.dct_split else state_b.c_dct))

    def whole_leaf_spread(self, state_b: ClipState) -> float:
        """The largest difference between this rank's whole leaves and
        any other frames rank's copy (0.0 when they are identical)."""
        if self.F == 1:
            return 0.0
        mine = torch.cat([x.detach().reshape(-1) for x, w in zip(
            state_b, self.whole_leaves) if w])
        return max(float((p - mine).abs().max()) for p in self.gather(mine))


# -- the fold of one rank's clips ---------------------------------------------

def flatten_state(state_b: ClipState) -> ClipState:
    """[C, T, ...] batched state -> [C*T, ...] frames-folded state for the
    model chain: each clip's scale repeats over its frames (c_dct is
    never read by folded consumers)."""
    C, T = state_b.body_6d.shape[:2]
    return ClipState(body_6d=state_b.body_6d.reshape(C * T, -1),
                     scale=state_b.scale[:, None].expand(C, T).reshape(-1),
                     camera_ext=state_b.camera_ext.reshape(C * T, 4, 4),
                     c_dct=state_b.c_dct)


def _unfold(x: torch.Tensor, C: int) -> torch.Tensor:
    """[C*T, ...] -> [C, T, ...]."""
    return x.reshape((C, x.shape[0] // C) + x.shape[1:])


def contact_dist(solver: ClipSolver, verts_flat: torch.Tensor, C: int,
                 scenes_b: Optional[torch.Tensor] = None,
                 grid_b: Optional[NN.VoxelGrid] = None,
                 cands: Optional[NN.FrameCands] = None) -> torch.Tensor:
    """Folded queries [C*T, N, 3] -> squared NN distance [C*T, N] to each
    clip's scene: against the folded candidate tables when given (K1),
    else the folded exact voxel query ('grid') or each clip's padded
    scene (K2 over the clip axis, 'brute')."""
    if cands is not None:
        return NN.nn_to_candidates(verts_flat, cands)
    if solver.nn_impl == "grid":
        return NN.grid_min_dist_folded(grid_b, verts_flat, C)
    d, _ = NN.nn_brute(_unfold(verts_flat, C), scenes_b)
    return d.reshape(verts_flat.shape[:-1])


def _collision(solver: ClipSolver, verts_b: torch.Tensor,
               sdf_lin: SDF.SdfLin) -> torch.Tensor:
    C = verts_b.shape[0]
    per_clip = torch.vmap(lambda v, s0, g, v0: SDF.collision_penalty(
        v, SDF.SdfLin(s0=s0, g=g, v0=v0)))
    return solver.config.weights.collision * per_clip(
        verts_b, _unfold(sdf_lin.s0, C), _unfold(sdf_lin.g, C),
        _unfold(sdf_lin.v0, C))


def _call(name, fn, *inputs):
    """A segment run as a plain call (a rank with no frames collective)."""
    return fn(*inputs)


def phase_losses(solver: ClipSolver, phase: str, state_b: ClipState,
                 target_b: torch.Tensor, weights_b: torch.Tensor,
                 scenes_b: Optional[torch.Tensor] = None,
                 grid_b: Optional[NN.VoxelGrid] = None,
                 cands: Optional[NN.FrameCands] = None,
                 sdf_lin: Optional[SDF.SdfLin] = None,
                 shard: Optional[FrameShard] = None,
                 segment=None) -> torch.Tensor:
    """ClipSolver.phase_loss of every clip -> per-clip losses [C], the
    same recipes and terms (dct_a runs in run_phase, joints hoisted). On
    a frames shard, this rank's part of each clip's loss: the halo
    gathered, then the rank's own terms as the segment "own" and, where
    dct_b gathers the joints, the DCT term and the loss's sum as the
    segment "dct". `segment(name, fn, *inputs)` runs each (run_phase's
    PhaseProgram.segment on a frames rank; a plain call without one)."""
    sh = shard or FrameShard.whole(state_b.body_6d.shape[1])
    seg = segment or _call
    gathers = phase == "dct_b" and sh.gathers
    body_ext, cam_ext = sh.halo(state_b.body_6d, state_b.camera_ext)
    out = seg("own", lambda be, ce, *leaves: _own_losses(
        solver, phase, ClipState(*leaves), be, ce, target_b, weights_b,
        scenes_b, grid_b, cands, sdf_lin, sh, gathers),
        body_ext, cam_ext, *state_b)
    if not gathers:
        return out
    *terms, joints = out
    return seg("dct", lambda j, c, *t: _dct_b_loss(solver, sh, j, c, *t),
               sh.dct_joints(joints), state_b.c_dct, *terms)


def _own_losses(solver: ClipSolver, phase: str, state_b: ClipState,
                body_ext: torch.Tensor, cam_ext: torch.Tensor,
                target_b, weights_b, scenes_b, grid_b, cands, sdf_lin,
                sh: FrameShard, gathers: bool):
    """phase_losses' terms of the rank's own frames and its halo ->
    per-clip losses [C]; with `gathers` (dct_b), the terms the DCT term
    is added to and the rank's joints [C, L, J, 3] instead."""
    cfg = solver.config
    w = cfg.weights
    C = state_b.body_6d.shape[0]
    rec = w.rec * sh.scaled(torch.vmap(losses.rec_l1)(
        target_b, state_b.body_6d, weights_b), 0)
    smooth = sh.scaled(torch.vmap(losses.second_order_smoothness)(
        body_ext), 2)
    if phase == "local_b":
        return rec + smooth * cfg.phase_b_smooth_mult
    flat = flatten_state(state_b)
    if phase == "global_b":
        n1 = sh.ext(1)
        _, joints, _ = forward_world(
            solver.ctx, flatten_state(state_b._replace(
                body_6d=body_ext[:, :n1], camera_ext=cam_ext[:, :n1])),
            vertex_subset=solver.contact_vids, prune=solver._contact_prune,
            merge_joints=True)
        return (rec + sh.scaled(torch.vmap(losses.first_order_smoothness)(
            _unfold(joints, C)), 1) + smooth * cfg.phase_b_smooth_mult)
    robust = torch.vmap(losses.robust_contact)
    if phase in ("local_a", "global_a"):
        verts, _, _ = forward_world(
            solver.ctx, flat, vertex_subset=solver.contact_vids,
            prune=solver._contact_prune, with_joints=False)
        mult = (cfg.local_contact_mult if phase == "local_a"
                else cfg.global_contact_mult)
        contact = w.contact * sh.scaled(robust(_unfold(contact_dist(
            solver, verts, C, scenes_b, grid_b, cands), C)), 0)
        loss = contact * mult + smooth + rec
    elif phase == "dct_b":
        verts, joints, _ = forward_world(
            solver.ctx, flat, vertex_subset=solver.contact_vids,
            prune=solver._contact_prune, merge_joints=True)
        contact = w.contact * sh.scaled(robust(_unfold(contact_dist(
            solver, verts, C, scenes_b, grid_b, cands), C)), 0)
        terms = (rec, contact) + (() if sdf_lin is None else (sh.scaled(
            _collision(solver, _unfold(verts, C), sdf_lin), 0),))
        if gathers:
            return terms + (_unfold(joints, C),)
        return _dct_b_loss(solver, sh, _unfold(joints, C), state_b.c_dct,
                           *terms)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    if sdf_lin is not None:
        loss = loss + sh.scaled(_collision(solver, _unfold(verts, C),
                                           sdf_lin), 0)
    return loss


def _dct_b_loss(solver: ClipSolver, sh: FrameShard, joints_b, c_dct_b,
                rec, contact, collision=None) -> torch.Tensor:
    """dct_b's loss [C] from the DCT term's joints (sh.dct_joints) and
    c_dct, and the rank's other terms."""
    loss = (sh.dct_loss(joints_b, c_dct_b, solver.config.window) * 1e-4
            + rec * 0.5 + contact * 0.1)
    return loss if collision is None else loss + collision


def skate_losses(solver: ClipSolver, state_b: ClipState,
                 target_b: torch.Tensor, weights_b: torch.Tensor,
                 weight_right: torch.Tensor,
                 shard: Optional[FrameShard] = None,
                 segment=None) -> torch.Tensor:
    """ClipSolver.terms2's anti-skate objective of every clip -> [C]. On a
    frames shard, this rank's part, with weight_right [C, L + halo] from
    FrameShard.halo: the halo gathered, then the rank's own terms as the
    segment "own" (`segment` as phase_losses takes it)."""
    sh = shard or FrameShard.whole(state_b.body_6d.shape[1])
    body_ext, cam_ext = sh.halo(state_b.body_6d, state_b.camera_ext)
    return (segment or _call)("own", lambda be, ce, wr, *leaves: _own_skate(
        solver, ClipState(*leaves), be, ce, target_b, weights_b, wr, sh),
        body_ext, cam_ext, weight_right, *state_b)


def _own_skate(solver: ClipSolver, state_b: ClipState,
               body_ext: torch.Tensor, cam_ext: torch.Tensor, target_b,
               weights_b, weight_right, sh: FrameShard) -> torch.Tensor:
    """skate_losses' terms of the rank's own frames and its halo."""
    C = state_b.body_6d.shape[0]
    verts, _, _ = forward_world(
        solver.ctx, flatten_state(state_b._replace(body_6d=body_ext,
                                                   camera_ext=cam_ext)),
        vertex_subset=solver._skate_vids, prune=solver._skate_prune,
        with_joints=False)
    verts = _unfold(verts, C)
    rec = solver.config.weights.rec * sh.scaled(torch.vmap(losses.rec_l1)(
        target_b, state_b.body_6d, weights_b), 0)
    second = torch.vmap(losses.second_order_smoothness)
    local_s = sh.scaled(second(body_ext), 2)
    vert_s = sh.scaled(second(verts), 2)
    n1 = sh.ext(1)
    skate = sh.scaled(torch.vmap(losses.foot_skate)(
        verts[:, :n1, solver._skate_left], verts[:, :n1, solver._skate_right],
        weight_right[:, :n1]), 1)
    return vert_s + local_s + rec + skate


def run_phase(solver: ClipSolver, phase: str, state_b: ClipState,
              opt: Adam, target_b: torch.Tensor,
              weights_b: torch.Tensor, num_steps: int,
              scenes_b: Optional[torch.Tensor] = None,
              grid_b: Optional[NN.VoxelGrid] = None,
              cands: Optional[NN.FrameCands] = None,
              sdf_lin: Optional[SDF.SdfLin] = None,
              weight_right: Optional[torch.Tensor] = None,
              shard: Optional[FrameShard] = None,
              program: Optional[step_graph.PhaseProgram] = None,
              key: Tuple = ()) -> torch.Tensor:
    """num_steps Adam steps of one phase over the rank's clips (the
    reference's build_sharded_step and phase_scan) -> per-clip losses
    [num_steps, C]. dct_a computes the world joints once (the body is
    frozen), as the single-clip solver does; 'skate' takes the
    planted-foot weights. On a frames shard the whole leaves' gradients
    are summed over the frames ranks before every step, and the history,
    the ranks' partial losses, once at the end. `program` runs the steps
    (eager without one); its graph of the phase is keyed by the phase,
    the contact inputs and `key`, and the inputs that change between
    runs of a key (tables, linearization, joints) are staged into the
    buffers it reads. A rank of a frames group above one rank runs its
    step around the collectives (the halo, the gathered joints, the
    gradient sum), the pieces between them the program's segments under
    the same key (ClipSolver._run_steps)."""
    mask = solver.phase_mask(phase)
    sh = shard or FrameShard.whole(state_b.body_6d.shape[1])
    program = program or step_graph.eager(solver.device)
    key = (phase, cands is not None, sdf_lin is not None) + tuple(key)
    cands, sdf_lin = stage_contact(program, key, cands, sdf_lin)
    frames = sh.F > 1
    seg = ((lambda name, fn, *xs: program.segment(key + (name,), fn, *xs))
           if frames else _call)

    def steps(loss_fn):
        return sh.all_reduce(solver._run_steps(
            state_b, opt, mask, num_steps, loss_fn,
            reduce_grads=((lambda: sh.reduce_grads(state_b, mask))
                          if frames else None),
            program=program, key=key))

    if phase == "dct_a":
        cfg = solver.config
        C = state_b.body_6d.shape[0]
        with torch.no_grad():
            _, joints, _ = forward_world(solver.ctx, flatten_state(state_b),
                                         vertex_subset=solver.contact_vids,
                                         prune=solver._contact_prune)
            joints, = program.stage(key + ("joints",), (
                sh.dct_joints(_unfold(joints, C)),))
        return steps(lambda st: seg("own", lambda c: sh.dct_loss(
            joints, c, cfg.window) * cfg.dct_mult, st.c_dct))
    if phase == "skate":
        return steps(lambda st: skate_losses(
            solver, st, target_b, weights_b, weight_right, sh, seg))
    return steps(lambda st: phase_losses(
        solver, phase, st, target_b, weights_b, scenes_b, grid_b, cands,
        sdf_lin, sh, seg))


@torch.no_grad()
def refresh_cands(solver: ClipSolver, state_b: ClipState,
                  grid_b: NN.VoxelGrid,
                  out: Optional[NN.FrameCands] = None) -> NN.FrameCands:
    """The folded candidate tables [C*T, P] of the current contact
    vertices (the reference's build_sharded_refresh, folded as it folds
    on one device), into `out`'s tensors when given. Compaction runs one
    clip's frames at a time, so its [T, N, P] scoring tensors are a
    single clip's size: it is per frame, so this changes no table."""
    C, T = state_b.body_6d.shape[:2]
    verts, _, _ = forward_world(solver.ctx, flatten_state(state_b),
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
    budget = solver.config.contact_cell_budget
    P_out = solver.config.contact_compact
    if not P_out or P_out >= budget * grid_b.cand_pts.shape[2]:
        return NN.frame_candidates_folded(grid_b, verts, C, budget, out)
    fc = NN.frame_candidates_folded(grid_b, verts, C, budget)
    if out is None:
        out = NN.FrameCands(
            cand=fc.cand.new_empty((C * T, P_out, 3)),
            valid=fc.valid.new_empty((C * T, P_out)))
    for s in range(0, C * T, T):
        rows = slice(s, s + T)
        NN.compact_candidates(
            verts[rows], NN.FrameCands(fc.cand[rows], fc.valid[rows]),
            P_out, out=NN.FrameCands(out.cand[rows], out.valid[rows]))
    return out


@torch.no_grad()
def refresh_sdf(solver: ClipSolver, state_b: ClipState,
                out: Optional[SDF.SdfLin] = None) -> SDF.SdfLin:
    """The scene SDF linearized at the folded contact vertices [C*T, N]
    (the solver's one SDF serves every clip), into `out`'s tensors when
    given."""
    verts, _, _ = forward_world(solver.ctx, flatten_state(state_b),
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
    return SDF.linearize(solver.sdf, verts, out)


@torch.no_grad()
def detect_contact(solver: ClipSolver, state_b: ClipState,
                   scenes_b: Optional[torch.Tensor] = None,
                   grid_b: Optional[NN.VoxelGrid] = None) -> torch.Tensor:
    """Per-clip planted-foot weights [C, T] (ClipSolver.detect_contact of
    every clip): the mean exact NN distance of each foot's vertices, by
    the folded voxel query or K2 over the clips' scenes."""
    C = state_b.body_6d.shape[0]
    n_left = len(solver.contact_vids_left)
    verts, _, _ = forward_world(solver.ctx, flatten_state(state_b),
                                vertex_subset=solver._feet_vids,
                                prune=solver._feet_prune, with_joints=False)
    d_l = torch.mean(contact_dist(solver, verts[:, :n_left], C, scenes_b,
                                  grid_b), dim=1)
    d_r = torch.mean(contact_dist(solver, verts[:, n_left:], C, scenes_b,
                                  grid_b), dim=1)
    return _unfold(losses.planted_foot_weight(d_l, d_r), C)
