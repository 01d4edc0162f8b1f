"""Headline benchmark of the port: the 900-frame clip solve's wall clock
on one card (the counterpart of the repository root's bench.py).

    python -m fpv4d_torch.bench [--device cuda|cpu]

Runs the standard problem at full width (utils/bench_problem: T=900,
V=10,475, 100,489 scene points, compact 192, skate 1024 body-only) in
bench.py's blocks and order: the 'local' solve through the public
ClipSolver.fit (first and steady), per-phase timing with FLOP and byte
shares of every requested mode, the 'global' and 'dct' solves, the dct
closed-form start, the keypoint fit (Adam, its 8-clip fleet, and the
three optimizers), both hand-written kernels held bit-exactly against
their plain versions, the ground-truth accuracy report, and the
multi-clip fleet.

Every block is fatal: a block or check that fails prints what failed
on stderr and exits non-zero, with no result line. There is no CPU
fallback: without a card the bench exits 1 unless --device cpu is
given, which runs small (FPV4D_BENCH_SMALL) and reports every share
taken from a time on the card (mfu, tflops_achieved, gbps, bytes_frac,
busy_frac, the kernels' ms and shares) as null.

The last line of stdout is one compact JSON object,
  {"metric": "clip_joint_opt_<T>f_local_mode_wallclock", "value": s,
   "unit": "s", "vs_baseline": 60/value, "correct": true,
   "extras": {...}},
under 2,000 characters; the full results go to FPV4D_BENCH_OUT.

Env knobs (bench.py's):
  FPV4D_BENCH_FRAMES       clip length (default 900; 60 small)
  FPV4D_BENCH_SMALL=1      small run: V=512, 1,024 scene points, 20
                           iterations, 40 dct iterations
  FPV4D_BENCH_MODES        comma list, default "local,global,dct"
                           ("local" small)
  FPV4D_BENCH_MULTI=N      the fleet with N clips (default 8 on the card
                           at full size, 0 in small runs; 0 disables)
  FPV4D_BENCH_MULTI_MODES  1 (default): the fleet's global and dct too
  FPV4D_BENCH_SKATE_SUBSET anti-skate vertex subset (default 1024)
  FPV4D_BENCH_COMPACT      candidate compaction (default 192)
  FPV4D_BENCH_OUT          path of the full results (default
                           bench_torch_out.json beside the package)
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from fpv4d_torch.ops import cand_cuda as C
from fpv4d_torch.ops import chamfer_cuda as K
from fpv4d_torch.ops import cuda_build
from fpv4d_torch.ops import skin_cuda
from fpv4d_torch.solve.clip_solve import ClipSolver, ClipState, forward_world
from fpv4d_torch.utils import cost
from fpv4d_torch.utils import observability as OBS
from fpv4d_torch.utils.bench_problem import keypoint_problem, standard_problem

ROOT = Path(__file__).resolve().parents[1]

# steps of a phase's profiled window
PROFILE_STEPS = 10
STEADY_RUNS = 3
# the compact line's limit: the tail a caller keeps of stdout
LINE_LIMIT = 2000
# a phase of at least this many steps must end below its first loss
# (a small run's shortest phases take 2-8 Adam steps, too few to fall)
MIN_FALLING_STEPS = 10


def _log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sig(x: Optional[float], digits: int = 4) -> Optional[float]:
    return None if x is None else float(f"{x:.{digits}g}")


@dataclasses.dataclass
class Knobs:
    small: bool
    T: int
    num_verts: int
    scene_pts: int
    num_iter: int
    num_iter_dct: int
    skate_subset: int
    compact: int
    modes: list
    multi: int
    multi_modes: bool
    out: str

    @classmethod
    def from_env(cls, env, on_card: bool) -> "Knobs":
        small = env.get("FPV4D_BENCH_SMALL") == "1" or not on_card
        multi = int(env.get("FPV4D_BENCH_MULTI", "0" if small else "8")
                    or 0)
        return cls(
            small=small,
            T=int(env.get("FPV4D_BENCH_FRAMES", "60" if small else "900")),
            num_verts=512 if small else 10475,
            scene_pts=1024 if small else 100_489,
            num_iter=20 if small else 500,
            num_iter_dct=40 if small else 10000,
            skate_subset=int(env.get("FPV4D_BENCH_SKATE_SUBSET", "1024")),
            compact=int(env.get("FPV4D_BENCH_COMPACT", "192")),
            modes=env.get("FPV4D_BENCH_MODES",
                          "local" if small else "local,global,dct"
                          ).split(","),
            multi=0 if multi == 0 else max(2, multi),
            multi_modes=env.get("FPV4D_BENCH_MULTI_MODES", "1") == "1",
            out=env.get("FPV4D_BENCH_OUT",
                        str(ROOT / "bench_torch_out.json")))


def schedule(cfg, mode: str):
    """[(phase, steps)] of a mode's Adam phases before detection."""
    n_a = int(cfg.num_iter * cfg.stage_split)
    if mode == "local":
        return [("local_a", n_a), ("local_b", cfg.num_iter - n_a)]
    if mode == "global":
        return [("global_a", n_a), ("global_b", cfg.num_iter - n_a)]
    n = cfg.num_iter_dct
    return [("dct_a", int(n * cfg.dct_split)),
            ("dct_b", n - int(n * cfg.dct_split))]


def mode_phases(cfg, mode: str):
    """Every Adam phase of a mode with its steps (local adds skate)."""
    out = schedule(cfg, mode)
    if mode == "local":
        out.append(("skate", int(cfg.contact_phase_frac * cfg.num_iter)))
    return out


def expected_launches(solver: ClipSolver, mode: str):
    """(K1, K2) launches of one fit: K1 once per step of each phase that
    reads lazy candidate tables; K2 never (the bench's solver takes the
    grid, so detection and the exact query launch no kernel)."""
    k1 = sum(n for p, n in schedule(solver.config, mode)
             if solver._use_lazy_contact(p))
    return k1, 0


def check_history(hist: Dict[str, np.ndarray], label: str,
                  falling: bool = True):
    """Finite losses; with `falling`, each phase of MIN_FALLING_STEPS
    steps or more ends below its first loss (every clip)."""
    for k, v in hist.items():
        v = np.asarray(v)
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{label} {k}: non-finite loss")
        if (falling and len(v) >= MIN_FALLING_STEPS
                and not np.all(v[-1] < v[0])):
            raise AssertionError(f"{label} {k}: loss did not decrease "
                                 f"({v[0]} -> {v[-1]})")


def snapshot(state: ClipState, opt):
    return ([x.detach().clone() for x in state],
            copy.deepcopy(opt.state_dict()))


def restore(state: ClipState, opt, snap):
    """The leaves and the Adam state copied back in place (a captured
    step goes on reading them)."""
    leaves, sd = snap
    with torch.no_grad():
        for x, s in zip(state, leaves):
            x.copy_(s)
    opt.load_state_dict(sd)


def shares(flops: float, nbytes: float, sec_per_step: float,
           on_card: bool) -> dict:
    """The counts of one step and, on the card, their rates and shares
    of the peaks (None off the card)."""
    out = {"gflops_per_step": flops / 1e9, "gbytes_per_step": nbytes / 1e9,
           "tflops_achieved": None, "mfu": None, "gbps": None,
           "bytes_frac": None}
    if on_card:
        out.update(tflops_achieved=flops / sec_per_step / 1e12,
                   mfu=flops / sec_per_step / cost.PEAK_F32_FLOPS,
                   gbps=nbytes / sec_per_step / 1e9,
                   bytes_frac=nbytes / sec_per_step / cost.HBM_BPS)
    return out


def counted(fn, dev: torch.device):
    """fn() under the port's trace (utils/observability.py), its counters
    reset just before it and read just after: (seconds to the card's
    end, its result, (K1, K2) launches)."""
    _sync(dev)
    OBS.reset_counts()
    t0 = time.perf_counter()
    with OBS.tracing():
        out = fn()
    _sync(dev)
    dt, got = time.perf_counter() - t0, OBS.counts()
    return dt, out, (got.get("k1/cuda", 0), got.get("k2/cuda", 0))


def fit_counted(fit, mode: str, label: str, solver: ClipSolver,
                falling: bool = True):
    """fit(mode=mode) of a solver or a fleet, counted: (seconds, hist,
    (K1, K2)), the histories checked (check_history) and, on the card,
    the launches (expected_launches)."""
    dt, (_, hist), got = counted(lambda: fit(mode=mode), solver.device)
    check_history(hist, label, falling)
    want = expected_launches(solver, mode)
    if solver.device.type == "cuda" and got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return dt, hist, got


def bench_mode(solver: ClipSolver, body, cam, mode: str,
               phases_out: dict) -> float:
    """bench.py's bench_mode: each phase of `mode` from one state chain,
    timed on the exact contact route (and on the lazy tables where the
    phase reads them), costed and, on the card, profiled; the stats go
    to phases_out by phase ('skate' for the anti-skate phase). Every
    run goes through one phase program on the solver's route (graphs on
    the card), so a phase's timed runs after its first include no
    capture. Returns the exact route's seconds, detection included."""
    cfg, dev = solver.config, solver.device
    st, target, weights = solver.init_state(body, cam)
    state, opt = solver.make_optimizer(st)
    program = solver.program()
    total = 0.0
    try:
        for phase, steps in schedule(cfg, mode):
            total += phase_stats(solver, state, opt, target, weights, steps,
                                 phase, phases_out, program)
        if mode == "local":
            dt, wr, _ = counted(lambda: solver.detect_contact(state), dev)
            total += dt
            steps = int(cfg.contact_phase_frac * cfg.num_iter)
            total += phase_stats(solver, state, opt, target, weights,
                                 steps, "skate", phases_out, program,
                                 weight_right=wr)
    finally:
        program.close()
    return total


def profile_production_step(solver: ClipSolver, state, opt, target,
                            weights, phase: str, run, lazy: bool,
                            program) -> dict:
    """A production step's busy share, launches and top kernel, from
    profiles of PROFILE_STEPS steps (on fixed tables where the phase
    reads lazy ones; graph replays on the graph route) and, for a lazy
    phase, of one table refresh through the program (a replay of its
    capture on the graph route), amortized over the refresh interval as
    production runs it. The busy share is the profiled windows' time
    with some kernel or copy running over their wall time (the
    refresh's window amortized into both). Launches are the kernels
    the profiler saw run per step (None where it saw none of a
    replay's)."""
    from fpv4d_torch.solve.clip_solve import refresh_contact
    from fpv4d_torch.utils.profile_local import measure
    dev = solver.device
    t0 = time.perf_counter()
    if lazy:
        cands = solver._refresh_cands(state)
        rec = measure(lambda n: solver._run_phase(
            state, opt, target, weights, n, phase, cands, program=program),
            PROFILE_STEPS, dev, top=1)
        key = (phase, True, solver.sdf is not None)
        ref = measure(lambda n: [refresh_contact(
            program, key, lambda out: solver._refresh_cands(state, out))
            for _ in range(n)], 1, dev, top=1)
        every = solver.config.contact_refresh_steps
        for k in ("wall_ms", "device_ms", "busy_ms", "window_ms",
                  "launches"):
            if rec[k] is not None:
                rec[k] += ref[k] / every
    else:
        rec = measure(run, PROFILE_STEPS, dev, top=1)
    return {"busy_frac": (None if rec["device_ms"] is None
                          else rec["busy_ms"] / rec["window_ms"]),
            "launches_per_step": rec["launches"],
            "top_kernel": rec["top"][0] if rec["top"] else None,
            "profile_s": time.perf_counter() - t0}


def phase_stats(solver: ClipSolver, state, opt, target, weights,
                steps: int, phase: str, phases_out: dict, program,
                weight_right=None) -> float:
    """One phase from `state` (bench.py's _phase_stats): the exact route
    timed; where the phase reads lazy tables, the same phase again from
    the same state on them (the state goes on from that run); the
    step's cost from shapes; then, on the card and in its own window, a
    profile of PROFILE_STEPS production steps (the state restored after
    it, profile_production_step). Returns the exact route's
    seconds."""
    dev = solver.device
    on_card = dev.type == "cuda"
    if phase == "skate":
        def run(n):
            return solver._run_skate_phase(state, opt, target, weights, n,
                                           weight_right, program)
    else:
        def run(n):
            return solver._run_phase(state, opt, target, weights, n, phase,
                                     program=program)
    snap = snapshot(state, opt)
    dt, hist, got = counted(lambda: run(steps).cpu().numpy(), dev)
    flops, nbytes = cost.step_cost(solver, phase, state, target, weights,
                                   weight_right=weight_right)
    stats = {"steps": steps, "final_loss": float(hist[-1]),
             "ms_per_step": dt / steps * 1e3,
             **shares(flops, nbytes, dt / steps, on_card)}
    lazy = phase != "skate" and solver._use_lazy_contact(phase)
    if lazy:
        restore(state, opt, snap)
        dt_l, hist_l, got = counted(lambda: solver._run_phase_auto(
            state, opt, target, weights, steps, phase,
            program).cpu().numpy(), dev)
        stats["ms_per_step_lazy"] = dt_l / steps * 1e3
        stats["final_loss_lazy"] = float(hist_l[-1])
        fl, nb = cost.step_cost(solver, phase, state, target, weights,
                                cands=solver._refresh_cands(state))
        stats["lazy"] = shares(fl, nb, dt_l / steps, on_card)
    stats["k1_launches"], stats["k2_launches"] = got
    stats.update(busy_frac=None, launches_per_step=None, top_kernel=None)
    if on_card:
        snap = snapshot(state, opt)
        stats.update(profile_production_step(solver, state, opt, target,
                                             weights, phase, run, lazy,
                                             program))
        restore(state, opt, snap)
    phases_out[phase] = stats
    return dt


class Bench:
    """One run: the blocks in bench.py's order, each a method (main runs
    them in BLOCKS order and stops at the first that raises)."""

    BLOCKS = ("setup", "headline", "modes", "dct_closed_form", "keypoints",
              "kernel_checks", "accuracy", "fleet")

    def __init__(self, dev: torch.device, knobs: Knobs):
        self.dev = dev
        self.on_card = dev.type == "cuda"
        self.k = knobs
        self.rng = np.random.RandomState(1)
        self.extras: dict = {"frames": knobs.T,
                             "skate_subset": knobs.skate_subset,
                             "contact_compact": knobs.compact,
                             "small": knobs.small, "block_s": {},
                             "modes": {}, "phases": {}}
        self.launches: Dict[str, list] = {}
        self.single_peak = None

    def fit(self, mode: str, label: str, solver: Optional[ClipSolver] = None,
            falling: bool = True):
        """One counted fit(mode) of the standard clip (fit_counted)."""
        solver = solver or self.solver
        return fit_counted(
            lambda mode: solver.fit(self.prob.body, self.prob.cam, mode=mode),
            mode, label, solver, falling)

    # -- blocks ---------------------------------------------------------------

    def setup(self):
        k = self.k
        if self.on_card:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0]
            self.extras["device"] = {
                "name": torch.cuda.get_device_name(self.dev),
                "count": torch.cuda.device_count(), "nvidia_smi": smi}
            self.power_limit = smi.split(",")[-1].strip()
        else:
            self.extras["device"] = {"name": "cpu", "count": 0,
                                     "nvidia_smi": None}
            self.power_limit = None
        self.extras["torch"] = torch.__version__
        _log(f"device={self.extras['device']} T={k.T} V={k.num_verts} "
             f"scene={k.scene_pts} iters={k.num_iter} modes={k.modes} "
             f"skate_subset={k.skate_subset} compact={k.compact} "
             f"multi={k.multi}")
        t0 = time.perf_counter()
        self.prob = standard_problem(
            T=k.T, num_verts=k.num_verts, scene_pts=k.scene_pts,
            num_iter=k.num_iter, num_iter_dct=k.num_iter_dct,
            skate_subset=k.skate_subset, contact_compact=k.compact,
            device=self.dev)
        self.solver = self.prob.solver
        self.extras["setup_s"] = time.perf_counter() - t0

    def headline(self):
        """The local fit through the public API: first (the kernels'
        build, then a fit that captures each phase's graph for the first
        time in the process) and the median of STEADY_RUNS steady
        fits."""
        ex = self.extras
        build_s = None
        if self.on_card:
            t0 = time.perf_counter()
            cuda_build.compile_sources([C.SRC, K.SRC, skin_cuda.SRC])
            C.build()
            K.build()
            skin_cuda.build()
            build_s = time.perf_counter() - t0
        dt0, _, _ = self.fit("local", "first local")
        ex["kernel_build_s"] = build_s
        ex["first_init_s"] = self.solver.phase_seconds["init"]
        ex["first_solve_s"] = dt0 + (build_s or 0.0)
        _log(f"first solve: {ex['first_solve_s']:.2f}s (kernel build "
             f"{build_s}, init {ex['first_init_s']:.2f}s)")
        runs = []
        for i in range(STEADY_RUNS):
            if self.on_card and i == STEADY_RUNS - 1:
                torch.cuda.reset_peak_memory_stats(self.dev)
            dt_i, hist, got = self.fit("local", f"steady local {i}")
            runs.append(dt_i)
        if self.on_card:
            self.single_peak = torch.cuda.max_memory_allocated(self.dev)
        self.dt = float(np.median(runs))
        self.launches["local"] = list(got)
        steps = sum(len(v) for v in hist.values())
        # the last steady fit's own seconds per stage, beside which the
        # per-phase windows of `modes` can be read
        ex["step_graphs"] = self.solver.step_graphs
        ex["modes"]["local"] = {
            "steady_s": self.dt, "steady_runs_s": runs,
            "frame_iters_per_s": self.k.T * steps / self.dt,
            "launches": list(got),
            "fit_phase_s": dict(self.solver.phase_seconds),
            "capture_s": dict(self.solver.capture_seconds)}
        _log(f"steady local solve: {self.dt:.2f}s median of {runs} "
             f"({steps} steps, {self.k.T * steps / self.dt:.0f} "
             f"frame-iters/s)")
        for k, v in hist.items():
            _log(f"  {k}: {v[0]:.4f} -> {v[-1]:.4f}")

    def modes(self):
        ex = self.extras
        for mode in self.k.modes:
            t_mode = bench_mode(self.solver, self.prob.body,
                                self.prob.cam, mode, ex["phases"])
            if mode != "local":
                dt_m, _, got = self.fit(mode, mode)
                self.launches[mode] = list(got)
                ex["modes"][mode] = {
                    "steady_s": dt_m, "steady_exact_s": t_mode,
                    "launches": list(got),
                    "fit_phase_s": dict(self.solver.phase_seconds),
                    "capture_s": dict(self.solver.capture_seconds)}
            entry = ex["modes"][mode]
            flops = sum(n * self.prod_flops(p)
                        for p, n in mode_phases(self.solver.config, mode))
            entry["gflops_per_solve"] = flops / 1e9
            # refreshes and detection are left out of the FLOPs, as
            # bench.py leaves them out
            entry["mfu"] = (flops / entry["steady_s"] / cost.PEAK_F32_FLOPS
                            if self.on_card else None)
            _log(f"mode {mode}: steady {entry['steady_s']:.2f}s, "
                 f"mfu {entry['mfu']}")
        for k, v in ex["phases"].items():
            _log(f"  {k}: {v['ms_per_step']:.3f} ms/step "
                 f"({v.get('ms_per_step_lazy')} lazy) "
                 f"{v['gflops_per_step']:.3f} GF mfu={v['mfu']} "
                 f"bytes_frac={v['bytes_frac']} busy={v['busy_frac']} "
                 f"launches/step={v['launches_per_step']}")

    def prod_flops(self, phase: str) -> float:
        """FLOPs of one production step of `phase` (the lazy tables'
        count where the phase reads them)."""
        p = self.extras["phases"][phase]
        return p.get("lazy", p)["gflops_per_step"] * 1e9

    def dct_closed_form(self):
        """bench.py's demo: dct_a started at the least-squares DCT fit,
        a tenth of the iterations, against the full schedule's dct_a."""
        if "dct" not in self.k.modes:
            return
        s = self.solver
        cfg_cf = dataclasses.replace(
            s.config, dct_closed_form_init=True,
            num_iter_dct=max(20, s.config.num_iter_dct // 10))
        solver_cf = ClipSolver(
            model=s.model, vposer_params=s.vposer_params,
            scene_verts=self.prob.scene, contact_vids=s.contact_vids,
            contact_vids_left=s.contact_vids_left,
            contact_vids_right=s.contact_vids_right, config=cfg_cf,
            nn_impl=s.nn_impl, grid=s.grid, device=self.dev)
        # dct_a starts at the least-squares optimum: its robust loss need
        # not fall from there
        dt, hist, _ = self.fit("dct", "dct closed form", solver_cf,
                               falling=False)
        full = self.extras["phases"].get("dct_a", {}).get("final_loss")
        self.extras["dct_closed_form"] = {
            "steady_s": dt, "iters": cfg_cf.num_iter_dct,
            "dct_a_final": float(hist["dct_a"][-1]),
            "full_schedule_dct_a_final": full}
        _log(f"dct closed-form init: {dt:.2f}s at {cfg_cf.num_iter_dct} "
             f"iters, dct_a final {hist['dct_a'][-1]:.6f} vs full-schedule "
             f"{full}")

    def keypoints(self):
        """Keypoint-fit frames/s (Adam), its fleet of clips batched, and
        each optimizer's frames/s, measured here (no compile step). The
        Adam stages take the default route (captured on the card, eager
        on the CPU), as do the L-BFGS stages; the route and each fit's
        capture seconds are recorded beside the rates."""
        from fpv4d_torch.config import KeypointFitConfig
        from fpv4d_torch.solve import keypoint_fit, step_graph
        model, vp, T, small = self.prob.model, self.prob.vp, self.k.T, \
            self.k.small
        self.extras["keypoint_step_graphs"] = step_graph.use_graphs(
            self.dev, None)
        captures = self.extras["keypoint_capture_s"] = {}

        def timed(kp, cfg, label):
            dt, (params, hist), got = counted(
                lambda: keypoint_fit.fit_keypoints(model, vp, kp, cfg,
                                                   device=self.dev),
                self.dev)
            captures[label] = dict(keypoint_fit.capture_seconds)
            if not (np.all(np.isfinite(params))
                    and all(np.all(np.isfinite(hist[k]))
                            for k in ("camera", "body", "all"))):
                raise AssertionError(f"keypoint fit {cfg.optimizer}: "
                                     "non-finite result")
            if got != (0, 0):
                raise AssertionError(f"keypoint fit {cfg.optimizer}: a "
                                     f"kernel ran off its path {got}")
            return dt, hist

        kp, kcfg = keypoint_problem(model, vp, T,
                                    num_iter=10 if small else 120)
        dt_fit, hist = timed(kp, kcfg, "fit")
        self.extras["keypoint_fit_fps"] = T / dt_fit
        _log(f"keypoint fit: {T} frames x {3 * kcfg.num_iter} steps in "
             f"{dt_fit:.2f}s -> {T / dt_fit:.0f} frames/s")
        C_kp = 2 if small else 8
        kp_b = np.broadcast_to(kp, (C_kp,) + kp.shape).copy()
        kp_b[..., :2] += self.rng.randn(*kp_b[..., :2].shape).astype(
            np.float32)
        dt_b, _ = timed(kp_b, kcfg, "fleet")
        self.extras["keypoint_fleet"] = {
            "clips": C_kp, "frames_per_s_per_chip": C_kp * T / dt_b,
            "per_clip_vs_single": dt_b / (C_kp * dt_fit)}
        _log(f"keypoint fleet: {C_kp} clips x {T} frames in {dt_b:.2f}s")
        # Adam's row is the fit above (the same configuration)
        runs = {"adam": (kcfg.num_iter, dt_fit, hist)}
        for name, iters in (("lbfgs", 15 if small else 60),
                            ("lbfgs_perframe", 10 if small else 40)):
            runs[name] = (iters, *timed(kp, KeypointFitConfig(
                num_iter=iters, optimizer=name), name))
        opts = {}
        for name, (iters, dt_o, hist) in runs.items():
            opts[name] = {"iters_per_stage": iters, "steady_s": dt_o,
                          "frames_per_s": T / dt_o, "capture_s": sum(
                              captures["fit" if name == "adam"
                                       else name].values()),
                          "final_all_loss": float(np.asarray(
                              hist["all"])[-1])}
            _log(f"keypoint {name}: {dt_o:.2f}s ({T / dt_o:.0f} frames/s)")
        self.extras["keypoint_optimizers"] = opts

    def kernel_checks(self):
        """K2 (bench.py's pallas_check) and K1 (its cand_kernel_check)
        held bit-exactly against their plain versions at bench.py's
        shapes and at the standard problem's, with kernel, plain and
        library times and the share of the bound; off the card only
        the shapes and bounds (the kernels run only on a card)."""
        solver, dev, rng = self.solver, self.dev, self.rng
        st, _, _ = solver.init_state(self.prob.body, self.prob.cam)
        with torch.no_grad():
            q_main = forward_world(solver.ctx, st,
                                   vertex_subset=solver.contact_vids,
                                   prune=solver._contact_prune,
                                   with_joints=False)[0].contiguous()
        scene = solver.scene

        def t(a):
            return torch.as_tensor(a, device=dev)

        k2 = {"bench": (t(rng.randn(64, 896, 3).astype(np.float32)),
                        scene[:4096].contiguous()),
              "global": (q_main, scene)}
        self.extras["pallas_check"] = self._check(
            "K2", k2, K.nn_distance_cuda, K.nn_distance_plain,
            _cdist_min_chunked,
            lambda x, y: cost.k2_bound_ms(x.numel() // 3, y.shape[0]))
        Tc, Nc, Pc = (64, 128, 128) if self.k.small else (900, 870, 512)
        qc = t(rng.randn(Tc, Nc, 3).astype(np.float32) * 2)
        cc = t(rng.randn(Tc, Pc, 3).astype(np.float32) * 2)
        vc = t(rng.rand(Tc, Pc) > 0.1)
        fc = solver._refresh_cands(st)
        k1 = {"bench": (qc, cc, vc), "standard": (q_main, fc.cand, fc.valid)}
        self.extras["cand_kernel_check"] = self._check(
            "K1", k1, C.cand_nn_cuda, C.cand_nn_plain,
            lambda q, c, v: torch.cdist(q, c).min(-1),
            lambda q, c, v: cost.k1_bound_ms(*q.shape[:2], c.shape[1]))

    def _check(self, name, cases, kernel, plain, library, bound):
        """Each case: kernel against plain, every output equal; times
        (CUDA-event medians; 2 runs of a plain version or library call
        that takes over 0.1 s) and the share of the bound."""
        out = {"ok": None if not self.on_card else True, "max_err": None,
               "cases": {}}
        for label, args in cases.items():
            b_ms, b_by = bound(*args)
            rec = {"shape": [list(a.shape) for a in args], "bound_ms": b_ms,
                   "bound_by": b_by, "ms": None, "plain_ms": None,
                   "library_ms": None, "share": None, "exact": None}
            if self.on_card:
                got = kernel(*args)
                slow, want, _ = counted(lambda: plain(*args), self.dev)
                exact = all(torch.equal(g, w) for g, w in zip(got, want))
                err = float((got[0] - want[0]).abs().max())
                reps = (2, 1) if slow > 0.1 else (20, 3)
                rec.update(
                    exact=exact, max_err=err,
                    ms=cost.median_ms(lambda: kernel(*args), reps=10),
                    plain_ms=cost.median_ms(lambda: plain(*args),
                                            reps=reps[0], warmup=reps[1]),
                    library_ms=cost.median_ms(lambda: library(*args),
                                              reps=reps[0],
                                              warmup=reps[1]))
                rec["share"] = b_ms / rec["ms"]
                out["ok"] = out["ok"] and exact
                out["max_err"] = max(out["max_err"] or 0.0, err)
            out["cases"][label] = rec
            _log(f"{name} {label} {rec['shape']}: exact={rec['exact']} "
                 f"kernel {rec['ms']} ms, plain {rec['plain_ms']} ms, "
                 f"library {rec['library_ms']} ms, bound {b_ms:.4f} ms "
                 f"({b_by})")
        if out["ok"] is False:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{out}")
        return out

    def accuracy(self):
        """utils/accuracy_report in a subprocess, on this run's device,
        held to tests/test_accuracy.py's limits. A small run passes
        smaller sizes (12 frames, 30 keypoint iterations, no deep or
        frontier rows)."""
        args = (["--frames", "12", "--num-verts", "256", "--iters", "30",
                 "--optimizer", "both"] if self.k.small else
                ["--frames", "24", "--num-verts", "256", "--iters", "60",
                 "--optimizer", "both", "--deep-iters", "180",
                 "--frontier-iters", "800", "--frontier-rec", "0.25"])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "fpv4d_torch.utils.accuracy_report",
             *args, "--device", self.dev.type], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=1800)
        if r.returncode != 0 or not r.stdout.strip():
            raise RuntimeError(f"accuracy report rc={r.returncode}: "
                               f"{r.stderr[-400:]}")
        acc = json.loads(r.stdout.strip().splitlines()[-1])
        acc["seconds"] = time.perf_counter() - t0
        self.extras["accuracy"] = acc
        checks = {
            "keypoint MPJPE < 60 mm": acc["keypoint_fit_mpjpe_mm"] < 60,
            "reprojection < 4x pixel noise":
                acc["keypoint_fit_reproj_px"] < 4 * acc["obs_noise_px"],
            "MPJPE after < before": acc["clip_solve_mpjpe_mm_after"]
                < acc["clip_solve_mpjpe_mm_before"],
            "jitter solved < 0.3x noisy": acc["jitter_mm_solved"]
                < 0.3 * acc["jitter_mm_noisy"]}
        failed = [k for k, ok in checks.items() if not ok]
        _log(f"accuracy: {acc}")
        if failed:
            raise AssertionError(f"accuracy report: failed {failed}")

    def fleet(self):
        """MultiClipSolver on {'clips': 1}: the standard clip C times,
        fenced and calibrated, steady, peak memory, the global and dct
        schedules, the grid cache."""
        if not self.k.multi:
            return
        from fpv4d_torch.parallel import sharding as SH
        from fpv4d_torch.parallel.multi_clip import (MultiClipSolver,
                                                     pad_scenes)
        Cn, T = self.k.multi, self.k.T
        mc = MultiClipSolver(solver=self.solver,
                             mesh=SH.make_mesh({"clips": 1}),
                             frame_axis=None)
        bodies = np.tile(self.prob.body[None], (Cn, 1, 1))
        cams = np.tile(self.prob.cam[None], (Cn, 1, 1, 1))
        scenes = pad_scenes([self.prob.scene] * Cn)

        def fit(mode, timings=None):
            dt, hist, _ = fit_counted(
                lambda mode: mc.fit(bodies, cams, scenes, mode=mode,
                                    timings=timings),
                mode, f"fleet {mode}", self.solver)
            return dt, hist

        # bench.py's attribution, run first (it also builds the grids
        # and grows the allocator before the steady fit): each stage
        # fenced, then calibrated by the per-fence overhead, (sum(raw) -
        # steady_s) / fences, times each stage's fence count
        tms: dict = {}
        dt_attr, _ = fit("local", timings=tms)
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
        dt_m, hist = fit("local")
        steps = sum(v.shape[0] for v in hist.values())
        m = {"clips": Cn, "steady_s": dt_m,
             "frame_iters_per_s": Cn * T * steps / dt_m,
             "clips_per_hour_per_chip": Cn * 3600.0 / dt_m,
             "per_clip_slowdown_vs_single": dt_m / (Cn * self.dt),
             "peak_gib": None, "gib_per_clip": None}
        if self.on_card:
            peak = torch.cuda.max_memory_allocated(self.dev)
            m["peak_gib"] = peak / 2 ** 30
            m["gib_per_clip"] = (peak - self.single_peak) / (Cn - 1) / 2 ** 30
        self.extras["multi_clip"] = m
        _log(f"multi-clip: {Cn} clips in {dt_m:.2f}s "
             f"({m['clips_per_hour_per_chip']:.1f} clips/h, "
             f"{m['per_clip_slowdown_vs_single']:.3f}x per clip vs single, "
             f"peak {m['peak_gib']} GiB)")
        fences = tms.pop("_fences", {})
        n_f = max(1, sum(fences.values()))
        over = max(0.0, sum(tms.values()) - dt_m) / n_f
        m["phase_s"] = {k: max(0.0, v - over * fences.get(k, 0))
                        for k, v in tms.items()}
        m["phase_s_raw"] = tms
        m["attribution"] = {
            "fenced_total_s": dt_attr, "fences": fences,
            "per_fence_overhead_s": over,
            "method": "raw minus per-fence overhead (= (sum(raw) - "
                      "steady_s)/n_fences) x stage fence count"}
        _log(f"multi-clip attribution: {m['phase_s']} "
             f"({over * 1e3:.1f} ms/fence x {n_f} fences)")
        if self.k.multi_modes:
            m["modes"] = {}
            for mode in ("global", "dct"):
                dt_mm, _ = fit(mode)
                single = self.extras["modes"].get(mode, {}).get("steady_s")
                m["modes"][mode] = {
                    "steady_s": dt_mm,
                    "clips_per_hour_per_chip": Cn * 3600.0 / dt_mm,
                    "per_clip_slowdown_vs_single":
                        dt_mm / (Cn * single) if single else None}
                _log(f"multi-clip {mode}: {Cn} clips in {dt_mm:.2f}s")
        m["grid_cache"] = {"hits": mc.grid_cache_hits,
                           "misses": mc.grid_cache_misses}

    # -- output ---------------------------------------------------------------

    def result(self) -> dict:
        """The full dict, and the compact line built from it."""
        ex, T = self.extras, self.k.T
        full = {"metric": f"clip_joint_opt_{T}f_local_mode_wallclock",
                "value": self.dt, "unit": "s",
                "vs_baseline": 60.0 / self.dt, "correct": True,
                "extras": ex}
        acc = ex["accuracy"]
        mc = ex.get("multi_clip", {})

        def phase_ms(p):
            return _sig(p.get("ms_per_step_lazy", p["ms_per_step"]))

        compact = {
            "metric": full["metric"], "value": round(self.dt, 3),
            "unit": "s", "vs_baseline": round(60.0 / self.dt, 3),
            "correct": True,
            "extras": {
                "device": ex["device"]["name"],
                "power_limit": self.power_limit,
                "modes_steady_s": {m: _sig(v["steady_s"])
                                   for m, v in ex["modes"].items()},
                "solve_mfu": {m: _sig(v["mfu"])
                              for m, v in ex["modes"].items()},
                "launches_per_solve": self.launches,
                "step_graphs": ex["step_graphs"],
                "capture_s": {m: _sig(sum(v["capture_s"].values()))
                              for m, v in ex["modes"].items()},
                "phase_ms_per_step": {k: phase_ms(v)
                                      for k, v in ex["phases"].items()},
                "k1_ms": _sig(ex["cand_kernel_check"]["cases"]["standard"]
                              ["ms"]),
                "k2_ms": _sig(ex["pallas_check"]["cases"]["global"]["ms"]),
                "keypoint_fit_fps": _sig(ex["keypoint_fit_fps"]),
                "keypoint_step_graphs": ex["keypoint_step_graphs"],
                "keypoint_capture_s": {
                    k: _sig(sum(v.values()))
                    for k, v in ex["keypoint_capture_s"].items()},
                "keypoint_fleet_fps": _sig(
                    ex["keypoint_fleet"]["frames_per_s_per_chip"]),
                "keypoint_optimizer_fps": {
                    k: _sig(v["frames_per_s"])
                    for k, v in ex["keypoint_optimizers"].items()},
                "fleet_clips_per_hour_per_chip": _sig(
                    mc.get("clips_per_hour_per_chip")),
                "fleet_per_clip_vs_single": _sig(
                    mc.get("per_clip_slowdown_vs_single")),
                "fleet_modes_clips_per_hour": {
                    m: _sig(v["clips_per_hour_per_chip"])
                    for m, v in mc.get("modes", {}).items()} or None,
                # the reference's HBM probe is a TPU tool, not ported
                "fleet_max_clips_per_chip": None,
                "fleet_implied_gb_per_clip": None,
                "fleet_gib_per_clip": _sig(mc.get("gib_per_clip")),
                "accuracy": {
                    "keypoint_mpjpe_mm": {
                        k: v.get("mpjpe_mm")
                        for k, v in acc.get("keypoint_fit", {}).items()},
                    "clip_mpjpe_mm": [
                        acc.get("clip_solve_mpjpe_mm_before"),
                        acc.get("clip_solve_mpjpe_mm_after"),
                        acc.get("clip_solve_deep", {}).get(
                            "mpjpe_mm_after")],
                    "frontier_mpjpe_mm": acc.get("frontier", {}).get(
                        "mpjpe_mm_after")},
                "pallas_ok": ex["pallas_check"]["ok"],
                "cand_kernel_ok": ex["cand_kernel_check"]["ok"],
                "full_results": os.path.basename(self.k.out)}}
        return full, compact


def _cdist_min_chunked(x: torch.Tensor, y: torch.Tensor):
    """torch.cdist + min over 8,192-query chunks (the library call that
    computes K2's function)."""
    xf = x.reshape(-1, 3)
    return [torch.cdist(xf[s:s + 8192], y).min(-1)
            for s in range(0, xf.shape[0], 8192)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request, "
                         "small)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("[bench] no CUDA device is available (pass --device cpu "
              "for a small run on the CPU)", file=sys.stderr)
        return 1
    knobs = Knobs.from_env(os.environ, dev.type == "cuda")
    bench = Bench(dev, knobs)
    block = None
    try:
        for block in Bench.BLOCKS:
            t0 = time.perf_counter()
            getattr(bench, block)()
            bench.extras["block_s"][block] = time.perf_counter() - t0
        block = "output"
        full, compact = bench.result()
        line = json.dumps(compact)
        if len(line) >= LINE_LIMIT:
            raise AssertionError(f"the result line has {len(line)} "
                                 f"characters (limit {LINE_LIMIT})")
        with open(knobs.out, "w") as f:
            json.dump(full, f, indent=1)
    except Exception:   # the boundary: name the failed block, no result
        traceback.print_exc()
        print(f"[bench] FAILED in block {block!r}", file=sys.stderr)
        return 1
    _log(f"full results -> {knobs.out}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
