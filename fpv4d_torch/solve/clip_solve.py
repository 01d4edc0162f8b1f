"""Clip-level joint optimization (port of fpv4d/solve/clip_solve.py).

Jointly optimizes, over a whole clip at once, the body parameter
sequence [T, 78] (6D-rotation layout), a global metric scale, per-frame
camera extrinsics [T, 4, 4] and DCT trajectory coefficients, with ONE
Adam state across every phase (as the reference makes its optax state
once per fit). The three modes and their stages:

  local   local_a   reconstruction + smoothness + contact
          local_b   reconstruction + smoothness
          detection planted-foot weights from the contact distance
          skate     anti-foot-skate refinement of the body sequence
  global  global_a  as local_a, with the global contact multiplier
          global_b  reconstruction + smoothness + world joint smoothness
  dct     dct_a     the DCT trajectory fit of c_dct alone, with the
                    joints computed once (the body is frozen)
          dct_b     DCT prior + reconstruction + contact

The contact distance has three sources (``_nn``): with
``nn_impl='grid'`` and ``contact_refresh_steps > 0``, per-frame
candidate tables rebuilt every that-many steps (kernel K1,
ops/cand_cuda.py); with 'grid' and ``contact_refresh_steps=0``, the
exact per-step voxel query; with ``nn_impl='brute'``, the whole scene
every step (kernel K2, ops/chamfer_cuda.py). With a scene SDF the
contact phases add the collision term, linearized at each refresh.

Each phase runs through a phase program (solve/step_graph.py): on the
card its step is captured once as a CUDA graph and replayed, the
counterpart of the reference's one jitted lax.scan per phase; on the CPU
(and on the card with ``step_graphs=False``) the same step runs eagerly.
The contact refresh and the SDF linearization between a phase's chunks
and the planted-foot detection run through the same program (on the
card each captured once, writing into the buffers the phase's graph
reads), the counterparts of the reference's jitted ones. The optimizer
is solve/adam.py, optax.adam's arithmetic with its state on the device.

On the card a solver keeps the program of its first fit, graphs and
all, for its life, as the reference keeps its jitted phases in
``self._compiled``: a later fit of the same signature (``_signature``)
copies its leaves, targets and weights into the buffers the graphs read,
zeroes the Adam state in place and replays from its first step, with no
eager warm-up and no capture.

Differences of form from the reference, none of value:
  * a phase's gradient mask detaches the leaves it does not optimize,
    and their ``.grad`` stays a zero tensor (never None, or Adam would
    skip them): masked leaves keep moving on their Adam moments exactly
    as the reference's zero gradients make them;
  * PyTorch does no dead-code elimination, so each phase computes only
    the terms and the FK call its loss reads (the reference leaves that
    pruning to XLA).
"""
from __future__ import annotations

import os
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fpv4d_torch.config import ClipConfig
from fpv4d_torch.core import rotations, transforms
from fpv4d_torch.models import params as P
from fpv4d_torch.models import vposer as VP
from fpv4d_torch.models.smplx import SmplxModel
from fpv4d_torch.ops import cand_cuda, chamfer_cuda, cuda_build, losses
from fpv4d_torch.ops import skin_cuda
from fpv4d_torch.ops import nn as NN
from fpv4d_torch.ops import sdf as SDF
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.adam import Adam
from fpv4d_torch.utils import observability as OBS
from fpv4d_torch.utils.checkpoint import save_solver_state

NN_IMPLS = ("grid", "brute")
MODES = ("local", "global", "dct")
# refresh interval of the SDF linearization when contact_refresh_steps
# is 0 (exact contact NN) but a scene SDF forces chunked phases
DEFAULT_REFRESH_STEPS = 50


class Ctx(NamedTuple):
    """What forward_world reads besides the state. The contact sources
    (scene, grid, candidate tables, SDF linearization) are not threaded
    through it as the reference threads them through jit: the solver
    holds the scene and grid, and the phases pass tables as arguments."""
    model: SmplxModel
    vposer: Dict[str, torch.Tensor]


class ClipState(NamedTuple):
    """Decision variables, one tensor per reference leaf."""
    body_6d: torch.Tensor      # [T, 78]
    scale: torch.Tensor        # scalar
    camera_ext: torch.Tensor   # [T, 4, 4]
    c_dct: torch.Tensor        # [W, J_dct, 3, K]


class Terms(NamedTuple):
    """All loss terms of the reference's cal_loss; collision is 0 unless
    the solver was given a scene SDF."""
    rec: torch.Tensor
    vposer: torch.Tensor
    contact: torch.Tensor
    smooth: torch.Tensor
    world_smooth: torch.Tensor
    dct: torch.Tensor
    collision: torch.Tensor


def _mask(body=False, scale=False, camera=False, dct=False) -> ClipState:
    """Per-leaf gradient mask of one phase."""
    return ClipState(body, scale, camera, dct)


def masked(state: ClipState, mask: ClipState) -> ClipState:
    """Detach the leaves a phase does not optimize, so the loss builds
    no backward graph into them."""
    return ClipState(*(x if m else x.detach() for x, m in zip(state, mask)))


# every joints consumer reads joints[:, :23], an ancestor-closed prefix
# of the SMPL-X tree, so the joints-only FK stops at the body subtree
_BODY_JOINTS = np.arange(23, dtype=np.int32)
_DUMMY_VERT = np.zeros(1, np.int32)


def forward_world(ctx: Ctx, state: ClipState, vertex_subset=None,
                  prune=None, merge_joints: bool = False,
                  with_joints: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict]:
    """body_6d -> world-space vertices [T,V,3] and joints [T,23,3]
    (joints transformed unscaled, as the reference does).

    prune: optional (joint_subset, pose_joint_subset) from
    model.joint_support(vertex_subset): the vertices then come from a
    support-pruned forward and the joints from a separate body-subtree
    call, which is skipped when with_joints is False (the reference
    relies on XLA to drop it). merge_joints serves both outputs from one
    call pruned to leg-support u body. Without prune the joints come
    from the full call, and joints_w is None when with_joints is
    False."""
    d = P.split_6d(state.body_6d)
    latent = d["body_pose"]
    common = dict(
        betas=d["betas"], global_orient=torch.zeros_like(d["transl"]),
        global_orient_matrot=rotations.rot6d_to_matrot(d["global_orient"]),
        body_pose_matrot=VP.decode(ctx.vposer, latent, output_type="matrot"),
        transl=d["transl"], left_hand_pose=d["left_hand_pose"],
        right_hand_pose=d["right_hand_pose"])
    if prune is None:
        out = ctx.model(**common, vertex_subset=vertex_subset)
        verts, joints = out["vertices"], out["joints"]
    elif merge_joints:
        js = prune[0]
        if js is not None:
            js = np.union1d(np.asarray(js), _BODY_JOINTS).astype(np.int32)
        out = ctx.model(**common, vertex_subset=vertex_subset,
                        joint_subset=js, pose_joint_subset=prune[1])
        verts, joints = out["vertices"], out["joints"]
    else:
        verts = ctx.model(**common, vertex_subset=vertex_subset,
                          joint_subset=prune[0],
                          pose_joint_subset=prune[1])["vertices"]
        joints = (ctx.model(**common, vertex_subset=_DUMMY_VERT,
                            joint_subset=_BODY_JOINTS)["joints"]
                  if with_joints else None)
    verts, joints, s, cam_ext, cam_t = OBS.mark("skin", (
        verts, joints if with_joints else None, state.scale,
        state.camera_ext, d["camera_translation"]))
    s_t = s[:, None] if s.ndim else s
    s_v = s[:, None, None] if s.ndim else s
    b2w = transforms.body2world(cam_ext, cam_t, s_t)
    verts_w = transforms.transform_points(verts * s_v, b2w)
    joints_w = (transforms.transform_points(joints[:, :23], b2w)
                if with_joints else None)
    verts_w, joints_w = OBS.mark("skin", (verts_w, joints_w), end=True)
    return verts_w, joints_w, {"latent": latent}


def capture_seconds(program: step_graph.PhaseProgram) -> Dict[str, float]:
    """A program's capture seconds summed by phase (a key's first
    element), named as fit's histories are."""
    out: Dict[str, float] = {}
    for key, sec in program.capture_seconds.items():
        name = "local_skate" if key[0] == "skate" else key[0]
        out[name] = out.get(name, 0.0) + sec
    return out


def _cands_tuple(fc: NN.FrameCands) -> tuple:
    return fc.cand, fc.valid


class _Kept(NamedTuple):
    """A graph-route phase program kept for a solver's life, the
    signature of the fits it serves (ClipSolver._signature), and the
    leaves its graphs read with the Adam over them (the program stages
    the fits' other inputs itself)."""
    signature: tuple
    program: step_graph.PhaseProgram
    state: ClipState
    opt: Adam

    def serves(self, signature: tuple) -> bool:
        (mine, held), (theirs, given) = self.signature, signature
        return mine == theirs and all(a is b for a, b in zip(held, given))


def _sdf_tuple(lin: SDF.SdfLin) -> tuple:
    return lin.s0, lin.g, lin.v0


def refresh_contact(program: step_graph.PhaseProgram, key: tuple,
                    refresh_cands=None, refresh_sdf=None):
    """A chunk's candidate tables and SDF linearization, each made by its
    refresh function (``fn(out)``, writing into `out`'s tensors when
    given; None makes None) through PhaseProgram.refresh under the keys
    that stage_contact reads for the phase graph `key`."""
    def run(name, fn, pack, unpack):
        if fn is None:
            return None
        return unpack(*program.refresh(key + (name,), lambda out: pack(
            fn(None if out is None else unpack(*out)))))

    return (run("cands", refresh_cands, _cands_tuple, NN.FrameCands),
            run("sdf", refresh_sdf, _sdf_tuple, SDF.SdfLin))


def stage_contact(program: step_graph.PhaseProgram, key: tuple,
                  cands: Optional[NN.FrameCands],
                  sdf_lin: Optional[SDF.SdfLin]):
    """A chunk's candidate tables and SDF linearization in the buffers the
    graph of `key` reads (PhaseProgram.stage; None stays None)."""
    if cands is not None:
        cands = NN.FrameCands(*program.stage(key + ("cands",),
                                             _cands_tuple(cands)))
    if sdf_lin is not None:
        sdf_lin = SDF.SdfLin(*program.stage(key + ("sdf",),
                                            _sdf_tuple(sdf_lin)))
    return cands, sdf_lin


def _as_f32(x, device) -> torch.Tensor:
    """A tensor, or a copy of an array (which may be read-only), as f32
    on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


class ClipSolver:
    """Owns the model, VPoser params, scene (and its grid for
    nn_impl='grid') and optional scene SDF; exposes fit().

    nn_impl: 'grid' (voxel-grid contact NN, as the reference picks on
    its accelerator) or 'brute' (exact search of the whole scene, the
    reference's 'pallas'/'xla'). The grid is built only for 'grid'.

    step_graphs: None runs each phase's step as a CUDA graph on a CUDA
    device and eagerly on the CPU; False runs it eagerly on either (the
    card's route to compare with); True on the CPU raises. On the graph
    route the solver keeps its fits' phase program until a fit of
    another signature (``_signature``: the clip's length, the config, the
    route, the section-marks switch, the scene, grid and SDF objects) or
    ``close``. The graphs also hold what the signature does not cover:
    the model, the VPoser weights, the vertex sets and any module-level
    function a step calls (a kernel route, the FK). A caller that swaps
    one of these between fits calls ``close`` first, or the next fit
    replays graphs of the old one."""

    def __init__(self, model: SmplxModel, vposer_params: Dict,
                 scene_verts, contact_vids, contact_vids_left,
                 contact_vids_right, config: ClipConfig = ClipConfig(),
                 nn_impl: str = "grid", grid_h: float = 0.25,
                 grid_slots: int = 8, grid: Optional[NN.VoxelGrid] = None,
                 sdf: Optional[SDF.SdfGrid] = None, device="cuda",
                 step_graphs: Optional[bool] = None):
        if nn_impl not in NN_IMPLS:
            raise ValueError(f"nn_impl={nn_impl!r}: one of {NN_IMPLS}")
        self.device = torch.device(device)
        self.step_graphs = step_graph.use_graphs(self.device, step_graphs)
        if self.device.type == "cuda":
            # the kernels a solve launches, their missing libraries
            # compiled side by side (each loads at its first launch)
            cuda_build.compile_sources([cand_cuda.SRC, chamfer_cuda.SRC,
                                        skin_cuda.SRC])
        self.config = config
        self.nn_impl = nn_impl
        self.model = model.to(self.device)
        self.vposer_params = {k: _as_f32(v, self.device)
                              for k, v in vposer_params.items()}
        self.scene = _as_f32(scene_verts, self.device)
        self.contact_vids = np.asarray(contact_vids, np.int32)
        self.contact_vids_left = np.asarray(contact_vids_left, np.int32)
        self.contact_vids_right = np.asarray(contact_vids_right, np.int32)
        self.grid_h, self.grid_slots = grid_h, grid_slots
        if nn_impl != "grid":
            grid = None
        elif grid is None:
            grid = NN.build_voxel_grid(
                np.asarray(scene_verts, np.float32), h=grid_h,
                slots_per_cell=grid_slots, device=self.device)
        else:
            grid = NN.VoxelGrid(cand_pts=grid.cand_pts.to(self.device),
                                cand_idx=grid.cand_idx.to(self.device),
                                origin=grid.origin.to(self.device),
                                dims=grid.dims, h=grid.h)
        self.grid = grid
        self.sdf = None if sdf is None else sdf.to(self.device)
        self.phase_seconds: Dict[str, float] = {}
        # host seconds of each phase's graph captures in the last fit
        self.capture_seconds: Dict[str, float] = {}
        # the last fit's trace counters (utils/observability.py; empty
        # with tracing off)
        self.trace_counts: Dict[str, int] = {}
        # the graph-route program kept from fit to fit
        self._kept: Optional[_Kept] = None

        # anti-skate vertex set: stratified sample + both feet
        n_sub = config.skate_subset
        if n_sub and n_sub < self.model.num_verts:
            pool = np.arange(self.model.num_verts, dtype=np.int64)
            if config.skate_body_only:
                # vertices skinned only by the body subtree, so the skate
                # FK prunes to <= 23 joints
                w = self.model.lbs_weights.detach().cpu().numpy()
                nb = len(_BODY_JOINTS)
                if w.shape[1] > nb:
                    ok = (w[:, nb:] == 0).all(axis=1)
                    if ok.any():
                        pool = pool[ok]
            strat = pool[np.linspace(0, len(pool) - 1,
                                     min(n_sub, len(pool)), dtype=np.int64)]
            vids = np.unique(np.concatenate(
                [strat, self.contact_vids_left, self.contact_vids_right]))
            self._skate_vids = vids.astype(np.int32)
            pos = {int(v): i for i, v in enumerate(vids)}
            skate_left = [pos[int(v)] for v in self.contact_vids_left]
            skate_right = [pos[int(v)] for v in self.contact_vids_right]
        else:
            self._skate_vids = None
            skate_left, skate_right = (self.contact_vids_left,
                                       self.contact_vids_right)
        self._skate_left = torch.as_tensor(np.asarray(skate_left, np.int64),
                                           device=self.device)
        self._skate_right = torch.as_tensor(
            np.asarray(skate_right, np.int64), device=self.device)
        # static joint-support pruning (None when nothing prunes)
        self._feet_vids = np.concatenate([self.contact_vids_left,
                                          self.contact_vids_right])
        self._contact_prune = self.model.joint_support(self.contact_vids)
        self._skate_prune = (self.model.joint_support(self._skate_vids)
                             if self._skate_vids is not None else None)
        self._feet_prune = self.model.joint_support(self._feet_vids)

    @property
    def ctx(self) -> Ctx:
        return Ctx(model=self.model, vposer=self.vposer_params)

    # -- geometry ------------------------------------------------------------

    def _nn(self, pts: torch.Tensor,
            cands: Optional[NN.FrameCands] = None) -> torch.Tensor:
        """[T, N, 3] -> squared NN distance [T, N] to the scene: against
        per-frame candidate tables when given (K1), else the exact
        per-step voxel query ('grid') or the whole scene ('brute', K2)."""
        if cands is not None:
            return NN.nn_to_candidates(pts, cands)
        if self.nn_impl == "grid":
            return NN.grid_min_dist(self.grid, pts)
        return NN.nn_brute(pts, self.scene)[0]

    def _contact(self, verts_w: torch.Tensor,
                 cands: Optional[NN.FrameCands]) -> torch.Tensor:
        """The weighted robust contact term of the NN distances (the
        contact section)."""
        verts_w = OBS.mark("contact", verts_w)
        contact = self.config.weights.contact * losses.robust_contact(
            self._nn(verts_w, cands))
        return OBS.mark("contact", contact, end=True)

    def _collision(self, verts_w: torch.Tensor,
                   sdf_lin: Optional[SDF.SdfLin]) -> torch.Tensor:
        verts_w = OBS.mark("losses", verts_w)
        return OBS.mark("losses", self.config.weights.collision
                        * SDF.collision_penalty(verts_w, sdf_lin), end=True)

    @staticmethod
    def _rec_smooth(w, target_6d, body_6d, frame_weights):
        """The weighted reconstruction term and the second-order
        smoothness of the body sequence (a losses section)."""
        body_6d = OBS.mark("losses", body_6d)
        rec = w.rec * losses.rec_l1(target_6d, body_6d, frame_weights)
        smooth = losses.second_order_smoothness(body_6d)
        return OBS.mark("losses", (rec, smooth), end=True)

    # -- objectives ----------------------------------------------------------

    def terms(self, state: ClipState, target_6d: torch.Tensor,
              frame_weights: torch.Tensor,
              cands: Optional[NN.FrameCands] = None, prune=None,
              merge_joints: bool = False,
              sdf_lin: Optional[SDF.SdfLin] = None) -> Terms:
        """All cal_loss terms, with the contact term against `cands`
        (or the per-step source of _nn without them). The phases compute
        only the terms they read (phase_loss); this full form serves
        inspection and the parity tests."""
        w = self.config.weights
        verts_w, joints_w, aux = forward_world(
            self.ctx, state, vertex_subset=self.contact_vids, prune=prune,
            merge_joints=merge_joints)
        collision = (self._collision(verts_w, sdf_lin)
                     if sdf_lin is not None
                     else torch.zeros((), device=self.device))
        return Terms(
            rec=w.rec * losses.rec_l1(target_6d, state.body_6d,
                                      frame_weights),
            vposer=w.vposer * losses.vposer_prior(aux["latent"]),
            contact=w.contact * losses.robust_contact(
                self._nn(verts_w, cands)),
            smooth=losses.second_order_smoothness(state.body_6d),
            world_smooth=losses.first_order_smoothness(joints_w),
            dct=losses.dct_trajectory(joints_w, state.c_dct,
                                      self.config.window),
            collision=collision)

    def terms2(self, state: ClipState, target_6d: torch.Tensor,
               frame_weights: torch.Tensor, weight_right: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
        """cal_loss2: (rec, local_smooth, vert_smooth, skate) of the
        anti-skate phase, on the stratified vertex subset when
        config.skate_subset > 0."""
        w = self.config.weights
        verts_w, _, _ = forward_world(self.ctx, state,
                                      vertex_subset=self._skate_vids,
                                      prune=self._skate_prune,
                                      with_joints=False)
        rec, local_smooth = self._rec_smooth(w, target_6d, state.body_6d,
                                             frame_weights)
        verts_w = OBS.mark("losses", verts_w)
        vert_smooth = losses.second_order_smoothness(verts_w)
        skate = losses.foot_skate(verts_w[:, self._skate_left],
                                  verts_w[:, self._skate_right],
                                  weight_right)
        vert_smooth, skate = OBS.mark("losses", (vert_smooth, skate),
                                      end=True)
        return rec, local_smooth, vert_smooth, skate

    def phase_loss(self, phase: str, state: ClipState, target_6d,
                   frame_weights, cands: Optional[NN.FrameCands] = None,
                   sdf_lin: Optional[SDF.SdfLin] = None) -> torch.Tensor:
        """Stage loss recipes (the reference's phase_loss), each
        computing only the terms it reads. The collision term rides with
        the contact term when a linearized SDF is given."""
        cfg = self.config
        w = cfg.weights
        rec, smooth = self._rec_smooth(w, target_6d, state.body_6d,
                                       frame_weights)
        if phase == "local_b":
            return rec + smooth * cfg.phase_b_smooth_mult
        if phase == "global_b":
            # joints only, from the merged body-subtree call; no contact
            _, joints_w, _ = forward_world(
                self.ctx, state, vertex_subset=self.contact_vids,
                prune=self._contact_prune, merge_joints=True)
            joints_w = OBS.mark("losses", joints_w)
            world = OBS.mark("losses", losses.first_order_smoothness(
                joints_w), end=True)
            return rec + world + smooth * cfg.phase_b_smooth_mult
        if phase == "dct_a":
            # the generic form; fit() runs dct_a with the joints hoisted
            _, joints_w, _ = forward_world(
                self.ctx, state, vertex_subset=self.contact_vids,
                prune=self._contact_prune)
            return self.dct_a_loss(joints_w, state)
        if phase in ("local_a", "global_a"):
            # verts only: the body-subtree joints FK and the DCT term
            # are not read
            verts_w, _, _ = forward_world(
                self.ctx, state, vertex_subset=self.contact_vids,
                prune=self._contact_prune, with_joints=False)
            mult = (cfg.local_contact_mult if phase == "local_a"
                    else cfg.global_contact_mult)
            contact = self._contact(verts_w, cands)
            loss = contact * mult + smooth + rec
        elif phase == "dct_b":
            # verts and joints from one merged body-subtree call
            verts_w, joints_w, _ = forward_world(
                self.ctx, state, vertex_subset=self.contact_vids,
                prune=self._contact_prune, merge_joints=True)
            joints_w, c_dct = OBS.mark("losses", (joints_w, state.c_dct))
            dct = OBS.mark("losses", losses.dct_trajectory(
                joints_w, c_dct, cfg.window), end=True)
            contact = self._contact(verts_w, cands)
            loss = dct * 1e-4 + rec * 0.5 + contact * 0.1
        else:
            raise ValueError(f"unknown phase {phase!r}")
        if sdf_lin is not None:
            loss = loss + self._collision(verts_w, sdf_lin)
        return loss

    @staticmethod
    def phase_mask(phase: str) -> ClipState:
        return {"local_a": _mask(body=True, scale=True),
                "local_b": _mask(body=True, camera=True),
                "global_a": _mask(body=True, scale=True),
                "global_b": _mask(body=True, camera=True),
                "dct_a": _mask(dct=True),
                "dct_b": _mask(body=True, scale=True),
                "skate": _mask(body=True)}[phase]

    # -- contact tables and SDF linearization ---------------------------------

    # contact phases eligible for the lazy-refresh tables
    _CONTACT_PHASES = ("local_a", "global_a", "dct_b")

    def _use_lazy_contact(self, phase: str) -> bool:
        return (self.nn_impl == "grid"
                and self.config.contact_refresh_steps > 0
                and phase in self._CONTACT_PHASES)

    @torch.no_grad()
    def _refresh_cands(self, state: ClipState,
                       out: Optional[NN.FrameCands] = None
                       ) -> NN.FrameCands:
        """Rebuild the per-frame candidate tables from the current
        world-space contact vertices (between step chunks), into `out`'s
        tensors when given."""
        verts_w, _, _ = forward_world(
            self.ctx, state, vertex_subset=self.contact_vids,
            prune=self._contact_prune, with_joints=False)
        P_out = self.config.contact_compact
        budget = self.config.contact_cell_budget
        with OBS.section("refresh", self.device):
            if not P_out or P_out >= budget * self.grid.cand_pts.shape[1]:
                return NN.frame_candidates(self.grid, verts_w, budget,
                                           out=out)
            return NN.compact_candidates(
                verts_w, NN.frame_candidates(self.grid, verts_w, budget),
                P_out, out=out)

    @torch.no_grad()
    def _refresh_sdf(self, state: ClipState,
                     out: Optional[SDF.SdfLin] = None) -> SDF.SdfLin:
        """Linearize the scene SDF at the current contact vertices (into
        `out`'s tensors when given)."""
        verts_w, _, _ = forward_world(
            self.ctx, state, vertex_subset=self.contact_vids,
            prune=self._contact_prune, with_joints=False)
        return SDF.linearize(self.sdf, verts_w, out)

    @torch.no_grad()
    def detect_contact(self, state: ClipState) -> torch.Tensor:
        """Per-frame planted-foot weight, left/(left+right), from the
        mean exact NN distance (voxel query or brute) of each foot's
        vertices."""
        n_left = len(self.contact_vids_left)
        verts_w, _, _ = forward_world(self.ctx, state,
                                      vertex_subset=self._feet_vids,
                                      prune=self._feet_prune,
                                      with_joints=False)
        verts_w = OBS.mark("contact", verts_w)
        d_l = torch.mean(self._nn(verts_w[:, :n_left]), dim=1)
        d_r = torch.mean(self._nn(verts_w[:, n_left:]), dim=1)
        return OBS.mark("contact", losses.planted_foot_weight(d_l, d_r),
                        end=True)

    # -- init ----------------------------------------------------------------

    @staticmethod
    def init_core(body_75: torch.Tensor, outlier_factor: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Outlier-aware init -> (seeded body_6d, target_6d,
        frame_weights): frames whose VPoser latent energy exceeds
        outlier_factor x mean get weight 0 and are re-seeded from the
        nearest good frame (ties to the earlier frame)."""
        T = body_75.shape[0]
        body_6d = rotations.params_to_6d(body_75)
        a, b = P.VPOSER_SLICE
        stats = torch.sum(body_75[:, a:b] ** 2, dim=1)
        good = stats <= outlier_factor * torch.mean(stats)
        idx = torch.arange(T, device=body_75.device)
        dist = (torch.abs(idx[:, None] - idx[None, :])
                + torch.where(good[None, :], 0, 10 * T))
        nearest_good = torch.argmin(dist, dim=1)
        seed_from = torch.where(good, idx, nearest_good)
        return body_6d[seed_from], body_6d, good.to(torch.float32)

    @torch.no_grad()
    def init_state(self, body_75, camera_ext
                   ) -> Tuple[ClipState, torch.Tensor, torch.Tensor]:
        """Seed the decision variables -> (state, target_6d,
        frame_weights)."""
        cfg = self.config
        body_75 = _as_f32(body_75, self.device)
        T = body_75.shape[0]
        body_init, target_6d, weights = self.init_core(body_75,
                                                       cfg.outlier_factor)
        c_dct = torch.zeros((T // cfg.window, cfg.num_dct_joints, 3,
                             cfg.dct_num), device=self.device)
        state = ClipState(
            body_6d=body_init,
            scale=torch.tensor(cfg.scale_init, dtype=torch.float32,
                               device=self.device),
            camera_ext=_as_f32(camera_ext, self.device).clone(),
            c_dct=c_dct)
        if cfg.dct_closed_form_init:
            _, joints_w, _ = forward_world(
                self.ctx, state, vertex_subset=self.contact_vids,
                prune=self._contact_prune)
            state = state._replace(c_dct=losses.dct_encode(
                joints_w[:, :cfg.num_dct_joints], cfg.window, cfg.dct_num))
        return state, target_6d, weights

    # -- phase runner ----------------------------------------------------------

    def make_optimizer(self, state: ClipState) -> Tuple[ClipState, Adam]:
        """Fresh leaf tensors + ONE Adam over all four leaves. Every
        leaf's .grad starts as a zero tensor and is zeroed in place each
        step, so leaves a phase does not reach still take Adam steps."""
        leaves = [x.detach().clone().requires_grad_(True) for x in state]
        return ClipState(*leaves), Adam(leaves, lr=self.config.lr)

    def program(self) -> step_graph.PhaseProgram:
        """A new phase program on this solver's route (fit keeps the one
        it makes on the graph route; the fleet and the profiles make one
        a call)."""
        return step_graph.PhaseProgram(self.device, self.step_graphs)

    def close(self) -> None:
        """Drop the kept program: its graphs, memory pool, side stream
        and the inputs they read. The next fit captures anew."""
        if self._kept is not None:
            self._kept.program.close()
            self._kept = None

    def _signature(self, body_75) -> tuple:
        """What a fit's graphs are captured for: the clip's length, the
        config (the graphs hold its weights and rates, and the leaves'
        shapes follow from it and the length), the route and the
        section-marks switch (marks are kernels in the graphs); then the
        contact sources, which callers swap between fits, compared by
        identity (the graphs hold their addresses)."""
        return ((np.shape(body_75)[0], self.config, self.step_graphs,
                 OBS.sections_on), (self.scene, self.grid, self.sdf))

    def _inputs(self, program: step_graph.PhaseProgram, signature: tuple,
                state: ClipState, target_6d: torch.Tensor,
                frame_weights: torch.Tensor) -> tuple:
        """A fit's (leaves, Adam, target_6d, frame_weights), where the
        program's graphs read them: the targets and weights staged; the
        leaves and their Adam made by the first fit of a graph-route
        program and kept with it, and a later fit's values copied into
        them, its Adam state zeroed, in place."""
        target_6d, frame_weights = program.stage(
            ("init", "targets"), (target_6d, frame_weights))
        kept = self._kept
        if kept is None:
            state, opt = self.make_optimizer(state)
            if program.graphs:
                self._kept = _Kept(signature, program, state, opt)
            return state, opt, target_6d, frame_weights
        with torch.no_grad():
            for held, x in zip(kept.state, state):
                held.copy_(x)
        kept.opt.reset()
        return kept.state, kept.opt, target_6d, frame_weights

    @staticmethod
    def _run_steps(state: ClipState, opt: Adam, mask: ClipState,
                   num_steps: int, loss_fn, reduce_grads=None,
                   program: Optional[step_graph.PhaseProgram] = None,
                   key=("steps",)) -> torch.Tensor:
        """num_steps Adam steps of loss_fn(masked state) -> per-step
        losses [num_steps] (kept on the device; read once per phase). A
        fleet's loss_fn returns per-clip losses [C]: the step descends
        their sum and the history is [num_steps, C]. A loss that reaches
        no leaf (a frames rank's share of a term it does not count) has
        no backward. `program` runs the steps (eager without one); a
        graph is captured once per `key`, a tuple that starts with the
        phase's name. reduce_grads, if given, is a collective run
        between the backward and the Adam step (a frames rank's sum of
        its whole leaves' gradients): such a step is not captured
        whole; it runs as it is, its loss's pieces between collectives
        captured as loss_fn's segments (PhaseProgram.segment) and its
        Adam step under `key` + ("adam",)."""
        def step():
            opt.zero_grad()
            loss = loss_fn(masked(state, mask))
            if loss.requires_grad:
                (loss.sum() if loss.ndim else loss).backward()
            if reduce_grads is None:
                opt.step()
            else:
                reduce_grads()
                program.call(key + ("adam",), opt.step)
            return loss.detach()

        program = program or step_graph.eager(state.body_6d.device)
        if reduce_grads is None:
            return program.run(key, step, num_steps)
        return program.loop(step, num_steps)

    def _run_phase(self, state, opt, target_6d, frame_weights,
                   num_steps: int, phase: str,
                   cands: Optional[NN.FrameCands] = None,
                   sdf_lin: Optional[SDF.SdfLin] = None,
                   program: Optional[step_graph.PhaseProgram] = None
                   ) -> torch.Tensor:
        if phase == "dct_a":
            return self._run_dct_only_phase(state, opt, num_steps, program)
        key = (phase, cands is not None, sdf_lin is not None)
        program = program or step_graph.eager(self.device)
        cands, sdf_lin = stage_contact(program, key, cands, sdf_lin)
        return self._run_steps(
            state, opt, self.phase_mask(phase), num_steps,
            lambda st: self.phase_loss(phase, st, target_6d, frame_weights,
                                       cands, sdf_lin), program=program,
            key=key)

    @torch.no_grad()
    def hoisted_joints(self, state: ClipState) -> torch.Tensor:
        """dct_a's world joints, computed once per phase: the body is
        frozen there."""
        return forward_world(self.ctx, state,
                             vertex_subset=self.contact_vids,
                             prune=self._contact_prune)[1]

    def dct_a_loss(self, joints_w: torch.Tensor, state: ClipState
                   ) -> torch.Tensor:
        """dct_a's step: the DCT residual of c_dct on hoisted joints."""
        joints_w, c_dct = OBS.mark("losses", (joints_w, state.c_dct))
        return OBS.mark("losses", losses.dct_trajectory(
            joints_w, c_dct, self.config.window) * self.config.dct_mult,
            end=True)

    def _run_dct_only_phase(self, state, opt, num_steps: int,
                            program: Optional[step_graph.PhaseProgram] = None
                            ) -> torch.Tensor:
        """dct_a optimizes c_dct alone: the body is frozen, so the world
        joints are computed once, without grad, and each step is the DCT
        residual and its c_dct gradient (the other three leaves keep zero
        gradients and move on their Adam moments)."""
        program = program or step_graph.eager(self.device)
        joints_w, = program.stage(("dct_a", "joints"),
                                  (self.hoisted_joints(state),))
        return self._run_steps(
            state, opt, self.phase_mask("dct_a"), num_steps,
            lambda st: self.dct_a_loss(joints_w, st), program=program,
            key=("dct_a", False, False))

    def _run_phase_auto(self, state, opt, target_6d, frame_weights,
                        num_steps: int, phase: str,
                        program: Optional[step_graph.PhaseProgram] = None
                        ) -> torch.Tensor:
        """Contact phases with lazy tables run as chunks of
        contact_refresh_steps steps, rebuilding the candidate tables (and
        the SDF linearization when a scene SDF is given) before each
        chunk. An SDF with contact_refresh_steps=0 refreshes its
        linearization every DEFAULT_REFRESH_STEPS steps. Every chunk
        replays the phase's one graph on the program's route: each
        refresh is copied into the buffers it reads."""
        lazy_contact = self._use_lazy_contact(phase)
        lazy_sdf = self.sdf is not None and phase in self._CONTACT_PHASES
        if not (lazy_contact or lazy_sdf):
            return self._run_phase(state, opt, target_6d, frame_weights,
                                   num_steps, phase, program=program)
        program = program or step_graph.eager(self.device)
        key = (phase, lazy_contact, lazy_sdf)
        chunk = max(1, self.config.contact_refresh_steps
                    or DEFAULT_REFRESH_STEPS)
        hists = []
        left = num_steps
        while left > 0:
            k = min(chunk, left)
            cands, lin = refresh_contact(
                program, key,
                (lambda out: self._refresh_cands(state, out))
                if lazy_contact else None,
                (lambda out: self._refresh_sdf(state, out))
                if lazy_sdf else None)
            hists.append(self._run_phase(state, opt, target_6d,
                                         frame_weights, k, phase, cands,
                                         lin, program))
            left -= k
        return torch.cat(hists)

    def skate_loss(self, state: ClipState, target_6d, frame_weights,
                   weight_right) -> torch.Tensor:
        """The anti-skate phase's loss, cal_loss2's terms summed."""
        rec, local_s, vert_s, skate = self.terms2(
            state, target_6d, frame_weights, weight_right)
        return vert_s + local_s + rec + skate

    def _run_skate_phase(self, state, opt, target_6d, frame_weights,
                         num_steps: int, weight_right,
                         program: Optional[step_graph.PhaseProgram] = None
                         ) -> torch.Tensor:
        """Anti-foot-skate refinement over the body sequence only."""
        return self._run_steps(
            state, opt, self.phase_mask("skate"), num_steps,
            lambda st: self.skate_loss(st, target_6d, frame_weights,
                                       weight_right), program=program,
            key=("skate", False, False))

    # -- public API ------------------------------------------------------------

    def fit(self, body_75, camera_ext, mode: str = "local",
            verbose: bool = False, checkpoint_dir: Optional[str] = None
            ) -> Tuple[ClipState, Dict[str, np.ndarray]]:
        """Run the staged solve of `mode` ('local', 'global' or 'dct').
        body_75 [T,75] packed SMPLify-X outputs, camera_ext [T,4,4]
        world-from-camera init (numpy or tensors).

        checkpoint_dir: if given, the state, the Adam state and the step
        count are written there after every phase, as ``<phase>.pt``
        (utils/checkpoint.py).

        On the graph route the fit runs on the program kept from an
        earlier fit of its signature (``_signature``), replaying its
        graphs, or on a new one that it keeps (closing the one kept
        before); a fit that raises keeps none.

        Returns a copy of the final state and the per-step loss history
        of each phase; the wall seconds of each stage land in
        ``self.phase_seconds``, the seconds of this fit's graph captures
        (inside its stage's) in ``self.capture_seconds``, empty when
        every graph was kept.

        With tracing on (utils/observability.py) the fit is a span
        ``fit`` holding a span ``phase/<stage>`` for each stage of
        ``phase_seconds`` and ``checkpoint`` for each checkpoint; the
        counters are reset at its start and kept in
        ``self.trace_counts`` after it, with ``captures``, the graphs
        this fit captured, and ``device_allocs``, the allocator's device
        allocations during the fit, on a card."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
        OBS.reset_counts()
        allocs = self._device_allocs()
        signature = self._signature(body_75)
        with OBS.span("fit"):
            if self._kept is not None and not self._kept.serves(signature):
                self.close()
            program = self._kept.program if self._kept else self.program()
            program.capture_seconds.clear()
            try:
                return self._fit(body_75, camera_ext, mode, verbose,
                                 checkpoint_dir, program, signature)
            except BaseException:
                self.close()
                raise
            finally:
                self.capture_seconds = capture_seconds(program)
                if self._kept is None:
                    program.close()
                OBS.count("captures", len(program.capture_seconds))
                if allocs is not None:
                    OBS.count("device_allocs",
                              self._device_allocs() - allocs)
                self.trace_counts = OBS.counts()

    def _device_allocs(self) -> Optional[int]:
        """The allocator's device allocations so far, read with tracing on
        and on a card only (else None)."""
        if not (OBS.spans_on and self.device.type == "cuda"):
            return None
        return torch.cuda.memory_stats(self.device)["num_device_alloc"]

    def _fit(self, body_75, camera_ext, mode, verbose, checkpoint_dir,
             program, signature):
        cfg = self.config
        hist: Dict[str, np.ndarray] = {}
        self.phase_seconds = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            with OBS.span(f"phase/{name}"):
                out = fn()
                if isinstance(out, torch.Tensor):
                    out = out.cpu()          # waits for the device
            self.phase_seconds[name] = time.perf_counter() - t0
            return out

        def init():
            state, target_6d, frame_weights = self.init_state(body_75,
                                                              camera_ext)
            return self._inputs(program, signature, state, target_6d,
                                frame_weights)

        state, opt, target_6d, frame_weights = timed("init", init)

        def ckpt(name):
            if checkpoint_dir:
                with OBS.span("checkpoint"):
                    save_solver_state(
                        os.path.join(checkpoint_dir, f"{name}.pt"), state,
                        opt, step=sum(len(v) for v in hist.values()))

        def phase(name, num_steps):
            hist[name] = timed(name, lambda: self._run_phase_auto(
                state, opt, target_6d, frame_weights, num_steps, name,
                program)).numpy()
            ckpt(name)

        n_a = int(cfg.num_iter * cfg.stage_split)
        if mode == "local":
            phase("local_a", n_a)
            phase("local_b", cfg.num_iter - n_a)
            weight_right = timed("detect_contact", lambda: program.refresh(
                ("detect_contact",), lambda _: (self.detect_contact(state),))
                [0])
            # at one address from fit to fit, where a kept skate graph
            # reads it
            weight_right, = program.stage(("skate", "weight_right"),
                                          (weight_right.to(self.device),))
            n_c = int(cfg.contact_phase_frac * cfg.num_iter)
            hist["local_skate"] = timed("local_skate", lambda:
                                        self._run_skate_phase(
                                            state, opt, target_6d,
                                            frame_weights, n_c,
                                            weight_right,
                                            program)).numpy()
            ckpt("local_skate")
        elif mode == "global":
            phase("global_a", n_a)
            phase("global_b", cfg.num_iter - n_a)
        else:
            n_dct_a = int(cfg.num_iter_dct * cfg.dct_split)
            phase("dct_a", n_dct_a)
            phase("dct_b", cfg.num_iter_dct - n_dct_a)
        if verbose:
            for k, v in hist.items():
                print(f"[fpv4d_torch.clip_solve] {k}: loss {v[0]:.4f} -> "
                      f"{v[-1]:.4f} ({len(v)} steps)")
        return ClipState(*(x.detach().clone() for x in state)), hist

    def result_params(self, state: ClipState
                      ) -> Tuple[np.ndarray, float, np.ndarray]:
        """Final (body_75 [T,75], scale, camera_ext [T,4,4]) as numpy."""
        with torch.no_grad():
            body = rotations.params_to_3d(state.body_6d)
        return (body.cpu().numpy(), float(state.scale),
                state.camera_ext.detach().cpu().numpy())
