"""The clip solve's driver: ``fpv4d_torch.solve.clip_solve.ClipSolver.fit``
over the session's clip stream.

Set-up makes the session's inputs on the device from the seed, builds
the port's model and one solver (its grid included), and warms up with
one solve of the cell's mode (it captures every graph the mode captures,
builds every kernel and grows the allocator's cache to a solve's). Each timed
solve is a whole ``fit(body, cam, mode, checkpoint_dir=...)`` of the
next clip, with its own init and graph captures, as a user pays them;
the checkpoints it writes after each phase (the CLI's
``--checkpoint-dir``) are what the check starts each phase from.
"""
from __future__ import annotations

import gc
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import profiling
from perfbench.counts import bounds, flops
from perfbench.inputs import synth
from perfbench.reference import check as REF
from perfbench.reference import objective as O

# kernel names of the contact searches in the device trace
K1_KERNEL = "cand_nn_kernel"
K2_KERNEL = "chamfer_nn_kernel"
# clips checked per run, drawn from the seed among those solved
CHECKED_CLIPS = 2


def clip_config(cfg: dict):
    """The port's ClipConfig with the configuration's settings."""
    from fpv4d_torch.config import ClipConfig
    return ClipConfig(
        num_iter=cfg["num_iter"], num_iter_dct=cfg["num_iter_dct"],
        lr=cfg["lr"], scale_init=cfg["scale_init"], window=cfg["window"],
        dct_num=cfg["dct_num"], outlier_factor=cfg["outlier_factor"],
        stage_split=cfg["stage_split"],
        contact_phase_frac=cfg["contact_phase_frac"],
        dct_split=cfg["dct_split"], skate_subset=cfg["skate_subset"],
        skate_body_only=cfg["skate_body_only"],
        contact_refresh_steps=cfg["refresh_steps"],
        contact_cell_budget=cfg["cell_budget"],
        contact_compact=cfg["compact"])


class Driver:
    """One run's solver over one session: `warm`, `solve` the window's
    clips, `trace` and `check` after it."""

    def __init__(self, cfg: dict, workload: dict, seed: int, device,
                 work_dir: str):
        from fpv4d_torch.models.smplx import SmplxModel
        from fpv4d_torch.solve.clip_solve import ClipSolver
        self.cfg, self.wl, self.seed = cfg, workload, int(seed)
        self.mode = workload["mode"]
        self.device = torch.device(device)
        self.work_dir = work_dir
        self.session = synth.session(seed, cfg, workload["clips"],
                                     self.device)
        s = self.session
        host = {k: v.cpu().numpy() for k, v in s.model.items()}
        model = SmplxModel(**host, device=self.device)
        left = s.vids_left.cpu().numpy().astype(np.int32)
        right = s.vids_right.cpu().numpy().astype(np.int32)
        self.config = clip_config(cfg)
        self.solver = ClipSolver(
            model=model, vposer_params=s.vposer,
            scene_verts=s.scene.cpu().numpy(),
            contact_vids=np.concatenate([left, right]),
            contact_vids_left=left, contact_vids_right=right,
            config=self.config, nn_impl=cfg["nn_impl"],
            grid_h=cfg["grid_h"], grid_slots=cfg["grid_slots"],
            device=self.device)
        self.hists: List[Dict[str, np.ndarray]] = []
        self.phase_seconds: List[Dict[str, float]] = []
        self.capture_seconds: List[float] = []

    def _ckpt(self, i: int) -> str:
        return os.path.join(self.work_dir, f"clip{i}")

    def warm(self):
        """One whole solve of the cell's mode."""
        self.solver.fit(self.session.bodies[-1], self.session.cams[-1],
                        mode=self.mode,
                        checkpoint_dir=os.path.join(self.work_dir, "warm"))

    def solve(self, i: int):
        """The timed solve of clip i."""
        if i >= self.session.bodies.shape[0] - 1:
            raise RuntimeError(f"the window outran the stream's "
                               f"{self.session.bodies.shape[0] - 1} clips")
        _, hist = self.solver.fit(self.session.bodies[i],
                                  self.session.cams[i], mode=self.mode,
                                  checkpoint_dir=self._ckpt(i))
        self.hists.append(hist)
        self.phase_seconds.append(dict(self.solver.phase_seconds))
        self.capture_seconds.append(sum(self.solver.capture_seconds.values()))

    # -- after the window ------------------------------------------------
    def trace(self, solved: int) -> Dict:
        """Two more solves of clip `solved` under the profiler: device
        activity alone (busy time and each kernel's time), then host and
        device (the breakdown); and the contact launches' shapes."""
        i = solved
        ck = os.path.join(self.work_dir, "traced")

        def run():
            with torch.profiler.record_function("perfbench.solve"):
                self.solver.fit(self.session.bodies[i], self.session.cams[i],
                                mode=self.mode, checkpoint_dir=ck)
        dev = profiling.device_window(run)
        brk = profiling.breakdown(run)
        T = self.cfg["frames"]
        N = self.session.vids_left.numel() + self.session.vids_right.numel()
        shapes = {}
        if self.cfg["nn_impl"] == "grid":
            shapes[K1_KERNEL] = bounds.k1_bound_ms(T, N,
                                                   self.cfg["compact"])[0]
        else:
            shapes[K2_KERNEL] = bounds.k2_bound_ms(
                T * N, self.session.scene.shape[0])[0]
        return {"device_window": dev, "breakdown": brk, "bound_ms": shapes}

    def free(self):
        """Drop the program's state before the reference runs."""
        self.solver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def problem(self) -> "O.Problem":
        return O.Problem(self.cfg, self.session, self.device)

    def count_flops(self, problem: "O.Problem") -> Dict[str, float]:
        s = self.session
        start = problem.init(s.bodies[0], s.cams[0])
        return flops.solve_flops(problem, self.mode, start)

    def checked(self, solved: int) -> List[int]:
        """The clips the check compares, drawn from the seed."""
        g = torch.Generator().manual_seed(self.seed % (1 << 63))
        pick = torch.randperm(solved, generator=g)[:CHECKED_CLIPS]
        return sorted(int(i) for i in pick)

    def check(self, problem: "O.Problem", solved: int,
              mode_precision: str = "f32",
              against: Optional[str] = None) -> Dict:
        """Per checked clip, the compared numbers (``check.numbers``) of
        the program's history against the reference's (``against`` a
        precision: the reference in `mode_precision` put in the
        program's place against the reference in `against`)."""
        out = {}
        for i in self.checked(solved):
            s = self.session
            ref = REF.reference_losses(problem, self.mode, s.bodies[i],
                                       s.cams[i], self._ckpt(i),
                                       mode_precision)
            if against is None:
                prog = {k: [float(x) for x in v[:REF.STEPS]]
                        for k, v in self.hists[i].items()}
            else:
                prog, ref = ref, REF.reference_losses(
                    problem, self.mode, s.bodies[i], s.cams[i],
                    self._ckpt(i), against)
            out[i] = REF.numbers(prog, ref)
        return out

    def close(self):
        shutil.rmtree(self.work_dir, ignore_errors=True)


def make(cfg: dict, workload: dict, seed: int, device, work_dir: str
         ) -> Driver:
    return Driver(cfg, workload, seed, device, work_dir)
