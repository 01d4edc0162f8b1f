"""The clips axis of a fleet solve (port of fpv4d/parallel/sharding.py).

The reference jits each phase of a batched fleet over a device mesh
with (clips x frames) shardings. The port has no mesh compiler, so it
splits the work in two:

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
    every rank every clip's results. Clips never interact, so nothing
    else is communicated.

A frames axis above 1 raises: sharding the frame axis needs a halo
exchange of the +-2-frame differences (and of the DCT windows), which
XLA inserts for the reference and which is not written here yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fpv4d_torch.ops import losses
from fpv4d_torch.ops import nn as NN
from fpv4d_torch.ops import sdf as SDF
from fpv4d_torch.solve.clip_solve import ClipSolver, ClipState, forward_world

FRAMES_AXIS_ITEM = "ROADMAP.md, queue 1, item 13"


# -- process group and mesh ---------------------------------------------------

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 device="cuda") -> bool:
    """Join a process group, gated so single-process runs are a strict
    no-op: active when FPV4D_DISTRIBUTED=1 (rank, world size and address
    then come from torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) or when an `init_method` is given. NCCL for a CUDA
    `device` (each rank on the card of its LOCAL_RANK unless the device
    names one), gloo for the CPU. Returns True if a process group is
    (or already was) initialized."""
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
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://", **kw)
    return True


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the process group (one rank when
    there is none), and this process's rank."""
    axes: Dict[str, int]
    rank: int = 0

    @property
    def size(self) -> int:
        return int(np.prod(list(self.axes.values()), dtype=np.int64))


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A mesh such as {'clips': 4} over the process group's ranks. Raises
    ValueError when the product of the axes is not the world size (1
    without a process group), and for a frames axis above 1."""
    axes = {str(k): int(v) for k, v in axes.items()}
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    if axes.get("frames", 1) > 1:
        raise ValueError(
            f"a frames axis of {axes['frames']}: sharding the frame axis "
            "needs a halo exchange of the +-2-frame differences, which is "
            f"not ported yet ({FRAMES_AXIS_ITEM}); use a clips axis")
    mesh = Mesh(axes, rank())
    if mesh.size != world_size():
        raise ValueError(f"mesh {axes} needs {mesh.size} ranks, the process "
                         f"group has {world_size()}")
    return mesh


def clip_range(mesh: Mesh, num_clips: int,
               clip_axis: str = "clips") -> Tuple[int, int]:
    """This rank's contiguous clips [start, stop) of num_clips: a clips
    axis of R ranks gives each num_clips / R (R must divide it)."""
    R = mesh.axes.get(clip_axis, 1)
    if num_clips % R:
        raise ValueError(f"{num_clips} clips do not split over a clips axis "
                         f"of {R} ranks")
    n = num_clips // R
    return mesh.rank * n, (mesh.rank + 1) * n


def all_gather_clips(x: torch.Tensor, mesh: Mesh,
                     dim: int = 0) -> torch.Tensor:
    """Every rank's part of a clip-axis tensor, concatenated in rank
    order along `dim` (x itself on a one-rank mesh)."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)


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


def phase_losses(solver: ClipSolver, phase: str, state_b: ClipState,
                 target_b: torch.Tensor, weights_b: torch.Tensor,
                 scenes_b: Optional[torch.Tensor] = None,
                 grid_b: Optional[NN.VoxelGrid] = None,
                 cands: Optional[NN.FrameCands] = None,
                 sdf_lin: Optional[SDF.SdfLin] = None) -> torch.Tensor:
    """ClipSolver.phase_loss of every clip -> per-clip losses [C], the
    same recipes and terms (dct_a runs in run_phase, joints hoisted)."""
    cfg = solver.config
    w = cfg.weights
    C = state_b.body_6d.shape[0]
    rec = w.rec * torch.vmap(losses.rec_l1)(target_b, state_b.body_6d,
                                            weights_b)
    smooth = torch.vmap(losses.second_order_smoothness)(state_b.body_6d)
    if phase == "local_b":
        return rec + smooth * cfg.phase_b_smooth_mult
    flat = flatten_state(state_b)
    if phase == "global_b":
        _, joints, _ = forward_world(
            solver.ctx, flat, vertex_subset=solver.contact_vids,
            prune=solver._contact_prune, merge_joints=True)
        return (rec + torch.vmap(losses.first_order_smoothness)(
            _unfold(joints, C)) + smooth * cfg.phase_b_smooth_mult)
    robust = torch.vmap(losses.robust_contact)
    if phase in ("local_a", "global_a"):
        verts, _, _ = forward_world(
            solver.ctx, flat, vertex_subset=solver.contact_vids,
            prune=solver._contact_prune, with_joints=False)
        mult = (cfg.local_contact_mult if phase == "local_a"
                else cfg.global_contact_mult)
        contact = w.contact * robust(_unfold(contact_dist(
            solver, verts, C, scenes_b, grid_b, cands), C))
        loss = contact * mult + smooth + rec
    elif phase == "dct_b":
        verts, joints, _ = forward_world(
            solver.ctx, flat, vertex_subset=solver.contact_vids,
            prune=solver._contact_prune, merge_joints=True)
        contact = w.contact * robust(_unfold(contact_dist(
            solver, verts, C, scenes_b, grid_b, cands), C))
        dct = torch.vmap(lambda j, c: losses.dct_trajectory(j, c,
                                                            cfg.window))
        loss = (dct(_unfold(joints, C), state_b.c_dct) * 1e-4 + rec * 0.5
                + contact * 0.1)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    if sdf_lin is not None:
        loss = loss + _collision(solver, _unfold(verts, C), sdf_lin)
    return loss


def skate_losses(solver: ClipSolver, state_b: ClipState,
                 target_b: torch.Tensor, weights_b: torch.Tensor,
                 weight_right: torch.Tensor) -> torch.Tensor:
    """ClipSolver.terms2's anti-skate objective of every clip -> [C]."""
    C = state_b.body_6d.shape[0]
    verts, _, _ = forward_world(solver.ctx, flatten_state(state_b),
                                vertex_subset=solver._skate_vids,
                                prune=solver._skate_prune, with_joints=False)
    verts = _unfold(verts, C)
    rec = solver.config.weights.rec * torch.vmap(losses.rec_l1)(
        target_b, state_b.body_6d, weights_b)
    local_s = torch.vmap(losses.second_order_smoothness)(state_b.body_6d)
    vert_s = torch.vmap(losses.second_order_smoothness)(verts)
    skate = torch.vmap(losses.foot_skate)(verts[:, :, solver._skate_left],
                                          verts[:, :, solver._skate_right],
                                          weight_right)
    return vert_s + local_s + rec + skate


def run_phase(solver: ClipSolver, phase: str, state_b: ClipState,
              opt: torch.optim.Adam, target_b: torch.Tensor,
              weights_b: torch.Tensor, num_steps: int,
              scenes_b: Optional[torch.Tensor] = None,
              grid_b: Optional[NN.VoxelGrid] = None,
              cands: Optional[NN.FrameCands] = None,
              sdf_lin: Optional[SDF.SdfLin] = None,
              weight_right: Optional[torch.Tensor] = None) -> torch.Tensor:
    """num_steps Adam steps of one phase over the rank's clips (the
    reference's build_sharded_step) -> per-clip losses [num_steps, C].
    dct_a computes the world joints once (the body is frozen), as the
    single-clip solver does; 'skate' takes the planted-foot weights."""
    mask = solver.phase_mask(phase)
    if phase == "dct_a":
        cfg = solver.config
        C = state_b.body_6d.shape[0]
        with torch.no_grad():
            _, joints, _ = forward_world(solver.ctx, flatten_state(state_b),
                                         vertex_subset=solver.contact_vids,
                                         prune=solver._contact_prune)
        joints = _unfold(joints, C)
        dct = torch.vmap(lambda j, c: losses.dct_trajectory(j, c,
                                                            cfg.window))
        return solver._run_steps(
            state_b, opt, mask, num_steps,
            lambda st: dct(joints, st.c_dct) * cfg.dct_mult)
    if phase == "skate":
        return solver._run_steps(
            state_b, opt, mask, num_steps, lambda st: skate_losses(
                solver, st, target_b, weights_b, weight_right))
    return solver._run_steps(
        state_b, opt, mask, num_steps, lambda st: phase_losses(
            solver, phase, st, target_b, weights_b, scenes_b, grid_b, cands,
            sdf_lin))


@torch.no_grad()
def refresh_cands(solver: ClipSolver, state_b: ClipState,
                  grid_b: NN.VoxelGrid) -> NN.FrameCands:
    """The folded candidate tables [C*T, P] of the current contact
    vertices (the reference's build_sharded_refresh, folded as it folds
    on one device). Compaction runs one clip's frames at a time, so its
    [T, N, P] scoring tensors are a single clip's size: it is per frame,
    so this changes no table."""
    C, T = state_b.body_6d.shape[:2]
    verts, _, _ = forward_world(solver.ctx, flatten_state(state_b),
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
    fc = NN.frame_candidates_folded(grid_b, verts, C,
                                    solver.config.contact_cell_budget)
    P_out = solver.config.contact_compact
    if not P_out:
        return fc
    parts = [NN.compact_candidates(
        verts[s:s + T], NN.FrameCands(fc.cand[s:s + T], fc.valid[s:s + T]),
        P_out) for s in range(0, C * T, T)]
    return NN.FrameCands(cand=torch.cat([p.cand for p in parts]),
                         valid=torch.cat([p.valid for p in parts]))


@torch.no_grad()
def refresh_sdf(solver: ClipSolver, state_b: ClipState) -> SDF.SdfLin:
    """The scene SDF linearized at the folded contact vertices [C*T, N]
    (the solver's one SDF serves every clip)."""
    verts, _, _ = forward_world(solver.ctx, flatten_state(state_b),
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
    return SDF.linearize(solver.sdf, verts)


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
