"""Multi-clip fleet solving (port of fpv4d/parallel/multi_clip.py).

Solves C clips at once with the single-clip solver's staged schedule:
all clips' decision variables are batched tensors with a leading clip
axis under ONE Adam, and each phase folds the clips into frames
(parallel/sharding.py), so a contact step launches K1 once for the
whole fleet (grid) or K2 once over the clips' padded scenes (brute).
Per-clip scenes are padded to a common size with far points that never
win a nearest-neighbour query; each clip's voxel grid is built from its
scene without them. A clips axis over torch.distributed ranks gives
each rank a contiguous share of the clips, and a frames axis a
contiguous share of each of those clips' frames (parallel/sharding.py
FrameShard: a halo of 2 frames, per-clip partial losses, whole leaves'
gradients summed): init runs on the whole clip, then each rank keeps
its frames, and the results are gathered over both axes.

Every rank runs each phase, each contact refresh, SDF linearization
and planted-foot detection through the solver's phase program
(solve/step_graph.py: on the card, CUDA graphs captured once and
replayed; ``ClipSolver(step_graphs=False)`` runs all of it eagerly).
On one rank of frames a phase's step is one graph. A rank of a frames
group above one rank runs its step around its collectives (the halo,
the gathered DCT joints, the whole leaves' gradient sum, all eager):
the pieces between them are the program's segments, captured once per
phase, and its Adam step a graph of its own (parallel/sharding.py
run_phase). The refresh, linearization and detection hold no
collective and are captured whole; the detection's halo is gathered
outside its graph.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fpv4d_torch.core import rotations
from fpv4d_torch.ops import nn as NN
from fpv4d_torch.parallel import sharding as SH
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.adam import Adam
from fpv4d_torch.solve.clip_solve import (DEFAULT_REFRESH_STEPS, ClipSolver,
                                          ClipState, _as_f32,
                                          capture_seconds, refresh_contact)

_FAR = 1e6


def pad_scenes(scenes: Sequence[np.ndarray]) -> np.ndarray:
    """List of [Mi, 3] clouds -> [C, Mmax, 3]; pad points sit at 1e6 so
    they never become nearest neighbours."""
    m = max(s.shape[0] for s in scenes)
    out = np.full((len(scenes), m, 3), _FAR, dtype=np.float32)
    for i, s in enumerate(scenes):
        out[i, :s.shape[0]] = s
    return out


@dataclass
class MultiClipSolver:
    """Batched clip solving over the clips and frames axes of a mesh (one
    rank's clips folded into frames; ranks split the clips, and the
    frames of each clip)."""
    solver: ClipSolver                   # shared model, config, device
    mesh: Optional[SH.Mesh] = None       # None: every rank on the clips
    clip_axis: str = "clips"
    frame_axis: Optional[str] = "frames"     # None: frames never split
    # run the skate phase in sub-batches of this many of a rank's clips
    # (0 = never): the reference's TPU measured the per-clip cost of its
    # skate step rising with the folded batch. Exact: per-clip gradients
    # and Adam moments never mix across clips.
    skate_clip_chunk: int = 2

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = SH.make_mesh({self.clip_axis: SH.world_size()})
        # voxel grids of the last scenes seen, keyed by their content
        self._grids = None
        self.grid_cache_hits = 0
        self.grid_cache_misses = 0
        # per phase of the last fit, the largest difference between this
        # frames rank's whole leaves (scale, a whole c_dct) and another
        # frames rank's copy: 0.0 while the copies move identically
        self.whole_leaf_spread: Dict[str, float] = {}
        # host seconds of each phase's graph captures in the last fit, and
        # of each capture by its program key
        self.capture_seconds: Dict[str, float] = {}
        self.capture_seconds_by_key: Dict[tuple, float] = {}

    def _get_grids(self, scenes) -> Optional[NN.VoxelGrid]:
        """The clips' batched voxel grid, cached by the scenes' CONTENT
        (scenes stay fixed across a deployment's repeated fit() calls;
        any change rebuilds). The far padding is stripped before
        building: it would blow the grids' bounding boxes."""
        if self.solver.nn_impl != "grid":
            return None
        arr = np.ascontiguousarray(np.asarray(scenes, np.float32))
        key = (arr.shape, hashlib.sha1(arr.tobytes()).hexdigest())
        if self._grids is not None and self._grids[0] == key:
            self.grid_cache_hits += 1
            return self._grids[1]
        self.grid_cache_misses += 1
        raw = [sc[np.all(np.abs(sc) < _FAR / 2, axis=1)] for sc in arr]
        grid_b = NN.build_voxel_grid_batch(
            raw, h=self.solver.grid_h, slots_per_cell=self.solver.grid_slots,
            device=self.solver.device)
        self._grids = (key, grid_b)
        return grid_b

    def init_batch(self, bodies, camera_exts
                   ) -> Tuple[ClipState, torch.Tensor, torch.Tensor]:
        """[C,T,75] + [C,T,4,4] -> batched (state, target, weights): the
        outlier-aware init of each clip (its outlier mean over its own
        frames), stacked."""
        per_clip = [self.solver.init_state(b, c)
                    for b, c in zip(bodies, camera_exts)]
        state_b = ClipState(*(torch.stack(xs) for xs in zip(
            *(s for s, _, _ in per_clip))))
        return (state_b, torch.stack([t for _, t, _ in per_clip]),
                torch.stack([w for _, _, w in per_clip]))

    def fit(self, bodies, camera_exts, scenes, mode: str = "local",
            timings: Optional[Dict[str, float]] = None
            ) -> Tuple[ClipState, Dict[str, np.ndarray]]:
        """Run the staged schedule of ClipSolver.fit for every clip at
        once. bodies [C,T,75], camera_exts [C,T,4,4], scenes [C,M,3]
        pre-padded (numpy: the grid cache hashes them). On a clips axis
        of R ranks each rank solves its C/R clips, on a frames axis of F
        ranks its T/F frames of them (F must divide T, leaving each rank
        >= 2 frames), and every rank of the mesh returns all of them; a
        rank outside the mesh raises.

        timings: optional dict; each stage is then FENCED (the card
        synchronized after it) and its wall seconds accumulate under
        'init', 'grids', 'detect', 'refresh', 'sdf_refresh' and the phase
        names, with the fences per key under timings['_fences'].

        Returns the batched final state and per-phase loss histories
        [steps, C]; the seconds of each phase's graph captures land in
        ``self.capture_seconds`` (by key in
        ``self.capture_seconds_by_key``)."""
        if not self.mesh.member:
            raise ValueError(f"rank {self.mesh.rank} is outside the mesh "
                             f"{self.mesh.axes}")
        bodies = np.asarray(bodies, np.float32)
        camera_exts = np.asarray(camera_exts, np.float32)
        scenes = np.asarray(scenes, np.float32)
        lo, hi = SH.clip_range(self.mesh, bodies.shape[0], self.clip_axis)
        program = self.solver.program()
        try:
            state_b, hist = self._fit_fold(bodies[lo:hi], camera_exts[lo:hi],
                                           scenes[lo:hi], mode, timings,
                                           program)
        finally:
            self.capture_seconds = capture_seconds(program)
            self.capture_seconds_by_key = dict(program.capture_seconds)
            program.close()
        if self.mesh.axes.get(self.clip_axis, 1) > 1:
            state_b = ClipState(*(SH.all_gather_clips(
                x, self.mesh, clip_axis=self.clip_axis) for x in state_b))
            hist = {k: SH.all_gather_clips(
                torch.as_tensor(v, device=self.solver.device), self.mesh,
                dim=1, clip_axis=self.clip_axis).cpu().numpy()
                for k, v in hist.items()}
        return state_b, hist

    def _fit_fold(self, bodies, camera_exts, scenes, mode, timings,
                  program):
        solver, cfg = self.solver, self.solver.config
        dev = solver.device

        def fenced(key, fn, *a, **kw):
            if timings is None:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
            fences = timings.setdefault("_fences", {})
            fences[key] = fences.get(key, 0) + 1
            return out

        # init reads whole clips (a clip-wide outlier mean, the nearest
        # good frame, the closed-form DCT fit); each rank then keeps its
        # frames
        shard = SH.FrameShard.of(self.mesh, bodies.shape[1], cfg.window,
                                 self.frame_axis)
        own = slice(shard.lo, shard.hi)

        def init():
            state_b, target_b, weights_b = self.init_batch(bodies,
                                                           camera_exts)
            return (*solver.make_optimizer(shard.split_state(state_b)),
                    target_b[:, own], weights_b[:, own])

        state_b, opt, target_b, weights_b = fenced("init", init)
        grid_b = fenced("grids", self._get_grids, scenes)
        scenes_b = (_as_f32(scenes, dev) if solver.nn_impl == "brute"
                    else None)

        n_a = int(cfg.num_iter * cfg.stage_split)
        if mode == "local":
            schedule = [("local_a", n_a), ("local_b", cfg.num_iter - n_a),
                        ("skate", int(cfg.contact_phase_frac
                                      * cfg.num_iter))]
        elif mode == "global":
            schedule = [("global_a", n_a),
                        ("global_b", cfg.num_iter - n_a)]
        elif mode == "dct":
            n = cfg.num_iter_dct
            schedule = [("dct_a", int(n * cfg.dct_split)),
                        ("dct_b", n - int(n * cfg.dct_split))]
        else:
            raise ValueError(f"unknown mode {mode!r}")

        C = bodies.shape[0]
        lazy_chunk = (cfg.contact_refresh_steps
                      if solver.nn_impl == "grid" else 0)
        contact = dict(scenes_b=scenes_b, grid_b=grid_b, shard=shard)
        hist: Dict[str, np.ndarray] = {}
        self.whole_leaf_spread = {}
        for phase, steps in schedule:
            if steps <= 0:
                continue
            use_sdf = (solver.sdf is not None
                       and phase in solver._CONTACT_PHASES)
            lazy_cands = bool(lazy_chunk) and phase in solver._CONTACT_PHASES
            weight_right = None
            if phase == "skate":
                # per frame, then the halo frames' weights from the next
                # frames rank (foot skate reads one)
                weight_right = fenced("detect", lambda: shard.halo(
                    program.refresh(("detect",), lambda _: (
                        SH.detect_contact(solver, state_b, scenes_b,
                                          grid_b),))[0])[0])
            if lazy_cands or use_sdf:
                # the single-clip solver's chunks: tables (and the SDF
                # linearization) rebuilt between chunks, never inside,
                # through the program (captured once on the card)
                chunk = max(1, lazy_chunk or cfg.contact_refresh_steps
                            or DEFAULT_REFRESH_STEPS)
                pkey = (phase, lazy_cands, use_sdf)
                hs = []
                for s in range(0, steps, chunk):
                    cands = (fenced("refresh", lambda: refresh_contact(
                        program, pkey, refresh_cands=lambda out:
                        SH.refresh_cands(solver, state_b, grid_b, out))[0])
                        if lazy_cands else None)
                    lin = (fenced("sdf_refresh", lambda: refresh_contact(
                        program, pkey, refresh_sdf=lambda out:
                        SH.refresh_sdf(solver, state_b, out))[1])
                        if use_sdf else None)
                    hs.append(fenced(phase, SH.run_phase, solver, phase,
                                     state_b, opt, target_b, weights_b,
                                     min(chunk, steps - s), cands=cands,
                                     sdf_lin=lin, program=program,
                                     **contact))
                h = torch.cat(hs)
            elif (phase == "skate" and self.skate_clip_chunk
                  and C > self.skate_clip_chunk
                  and C % self.skate_clip_chunk == 0):
                h = fenced(phase, self._run_skate_chunked, opt, target_b,
                           weights_b, weight_right, steps, shard, program)
            else:
                h = fenced(phase, SH.run_phase, solver, phase, state_b, opt,
                           target_b, weights_b, steps,
                           weight_right=weight_right, program=program,
                           **contact)
            key = "local_skate" if phase == "skate" else phase
            hist[key] = h.cpu().numpy()
            self.whole_leaf_spread[key] = shard.whole_leaf_spread(state_b)
        return (shard.join_state(ClipState(*(x.detach() for x in state_b))),
                hist)

    def _run_skate_chunked(self, opt: Adam, target_b, weights_b,
                           weight_right, steps: int, shard: SH.FrameShard,
                           program: step_graph.PhaseProgram) -> torch.Tensor:
        """The skate phase over sequential sub-batches of
        skate_clip_chunk clips, each on views of its clips' rows of the
        leaves, gradients and Adam moments (opt.select: the steps write
        the fleet's tensors in place) from the fleet's shared step count,
        which advances once after them. Each sub-batch is a graph of its
        own on the graph route."""
        k = self.skate_clip_chunk
        hs = []
        for c0 in range(0, opt.params[0].shape[0], k):
            sl = slice(c0, c0 + k)
            sub = opt.select(sl)
            hs.append(SH.run_phase(self.solver, "skate",
                                   ClipState(*sub.params), sub,
                                   target_b[sl], weights_b[sl], steps,
                                   weight_right=weight_right[sl],
                                   shard=shard, program=program,
                                   key=(c0,)))
        opt.count.copy_(sub.count)
        return torch.cat(hs, dim=1)

    def result_params(self, state_b: ClipState
                      ) -> List[Tuple[np.ndarray, float, np.ndarray]]:
        """Per-clip (body_75 [T,75], scale, camera_ext [T,4,4])."""
        C = state_b.body_6d.shape[0]
        with torch.no_grad():
            body = rotations.params_to_3d(
                state_b.body_6d.reshape(-1, state_b.body_6d.shape[-1]))
        body = body.reshape(C, -1, 75).cpu().numpy()
        cams = state_b.camera_ext.detach().cpu().numpy()
        scales = state_b.scale.detach().cpu().numpy()
        return [(body[c], float(scales[c]), cams[c]) for c in range(C)]
