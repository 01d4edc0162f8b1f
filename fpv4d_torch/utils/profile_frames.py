"""The frames axis on one card: each rank's fit and step on both routes.

    python -m fpv4d_torch.utils.profile_frames [--steps 20]

Spawns two gloo ranks on the one card (NCCL takes one rank per card), a
{clips: 1, frames: 2} mesh over the standard problem's 900 frames, 450
a rank. Each rank runs, on the graph route (its step captured in
segments between its collectives, parallel/sharding.py) and the eager
route (``step_graphs=False``) in turns, graph, eager, eager, graph:

* the whole ``local`` fit (``MultiClipSolver.fit``), every stage fenced:
  seconds per stage, K1 and K2 launches, capture seconds per key, peak
  memory;
* ``--steps`` local_a steps from the initial state against its
  refreshed tables, timed on the host clock around a synchronised window (after
  3 steps that warm up and capture), then as many again with every
  collective timed: the card synchronised before each, its host
  seconds summed (gloo stages a CUDA tensor through the host, so a
  collective waits for the work queued before it anyway); the share
  of a step they take;
* on the graph route, the same steps in a torch.profiler window: kernels
  per step on the card, those launched eagerly (``cudaLaunchKernel``)
  and the graph launches (``cudaGraphLaunch``), so the kernels per step
  inside replays are the first less the second; the busy share.

Beforehand the parent process builds the kernels and runs the single
solve of the whole clip (``ClipSolver.fit``, ``local``) on both routes
in the same turns, for comparison. It
prints one JSON object: the card's name and power limit, the single
solve's seconds per phase on each route and, per rank and route, those
numbers. ``--device cpu`` rehearses the control flow at a small size
(``--T 12 --num-verts 256 --scene-pts 400``), the eager route only: no
device numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from fpv4d_torch.ops import cand_cuda, chamfer_cuda
from fpv4d_torch.parallel import sharding as SH
from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
from fpv4d_torch.utils import observability as OBS
from fpv4d_torch.utils.bench_problem import standard_problem
from fpv4d_torch.utils.profile_local import _device_spans, _sync, busy_span

MESH = {"clips": 1, "frames": 2}
# the routes in turns, each run twice (the first run of a process pays
# its one-time costs: cuBLAS handles, the kernels' modules loading)
ROUTES = ("graph", "eager", "eager", "graph")


class _Timed:
    """The frames collectives (FrameShard.gather: the halo forward and
    backward and the gathered joints; torch.distributed.all_reduce: the
    gradient sum and the history) timed while installed: the card
    synchronised, then the call's host seconds summed."""

    def __init__(self, dev):
        self.dev, self.seconds, self.calls = dev, 0.0, 0

    def wrap(self, fn):
        def timed(*a, **kw):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return timed

    def __enter__(self):
        self._saved = SH.FrameShard.gather, dist.all_reduce
        SH.FrameShard.gather = self.wrap(SH.FrameShard.gather)
        dist.all_reduce = self.wrap(dist.all_reduce)
        return self

    def __exit__(self, *exc):
        SH.FrameShard.gather, dist.all_reduce = self._saved


def _fit(prob, mesh, dev) -> dict:
    """The fenced local fit on the frames mesh."""
    mc = MultiClipSolver(solver=prob.solver, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    tm = {}
    OBS.reset_counts()
    t0 = time.perf_counter()
    with OBS.tracing():
        mc.fit(prob.body[None], prob.cam[None], pad_scenes([prob.scene]),
               mode="local", timings=tm)
    _sync(dev)
    counts = OBS.counts()
    return {"seconds": time.perf_counter() - t0,
            "stages_s": {k: v for k, v in tm.items() if k != "_fences"},
            "launches": [counts.get("k1/cuda", 0),
                         counts.get("k2/cuda", 0)],
            "capture_s": {" ".join(map(str, k)): v
                          for k, v in mc.capture_seconds_by_key.items()},
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}


def _steps(prob, mesh, dev, steps: int) -> dict:
    """local_a steps on the state the problem's init gives, on the
    solver's route: ms per step, and with the collectives timed."""
    solver = prob.solver
    mc = MultiClipSolver(solver=solver, mesh=mesh)
    shard = SH.FrameShard.of(mesh, prob.body.shape[0], solver.config.window)
    own = slice(shard.lo, shard.hi)
    state_b, target_b, weights_b = mc.init_batch(prob.body[None],
                                                 prob.cam[None])
    state_b, opt = solver.make_optimizer(shard.split_state(state_b))
    grid_b = mc._get_grids(pad_scenes([prob.scene]))
    program = solver.program()
    cands = SH.refresh_cands(solver, state_b, grid_b)

    def run(n):
        SH.run_phase(solver, "local_a", state_b, opt, target_b[:, own],
                     weights_b[:, own], n, cands=cands, shard=shard,
                     program=program)

    run(3)                                  # warm-up and capture
    _sync(dev)
    t0 = time.perf_counter()
    run(steps)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with _Timed(dev) as tc:
        t0 = time.perf_counter()
        run(steps)
        _sync(dev)
        timed_ms = (time.perf_counter() - t0) * 1e3 / steps
    out = {"step_ms": step_ms, "step_ms_collectives_timed": timed_ms,
           "collective_ms": tc.seconds * 1e3 / steps,
           "collectives_per_step": tc.calls / steps,
           "collective_share": tc.seconds * 1e3 / steps / timed_ms}
    if program.graphs:
        out.update(_profiled(lambda: run(steps), dev, steps))
    program.close()
    return out


def _profiled(fn, dev, steps: int) -> dict:
    """Kernels per step on the card, eager launches and graph launches
    per step, and the busy share, in one profiled window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = eager = graphs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += not e.name.startswith(("Memcpy", "Memset"))
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            eager += 1
        elif e.name == "cudaGraphLaunch":
            graphs += 1
    busy_us, span_us = busy_span(_device_spans(prof))
    return {"kernels_per_step": kernels / steps,
            "eager_launches_per_step": eager / steps,
            "graph_launches_per_step": graphs / steps,
            "kernels_in_replays_per_step": (kernels - eager) / steps,
            "busy_share": busy_us / max(window_us, span_us)}


def _routes(dev) -> tuple:
    """ROUTES on the card; the CPU has the eager route alone."""
    return ROUTES if dev.type == "cuda" else ("eager",)


def _rank(rank: int, init_file: str, out_dir: str, args):
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    SH.maybe_initialize_distributed(init_method=f"file://{init_file}",
                                    world_size=2, rank=rank, device=dev,
                                    backend="gloo")
    mesh = SH.make_mesh(MESH)
    out = {}
    for route in _routes(dev):
        prob = standard_problem(T=args.T, num_verts=args.num_verts,
                                scene_pts=args.scene_pts, device=dev)
        prob.solver.step_graphs = route == "graph"
        out.setdefault(route, []).append({
            "fit": _fit(prob, mesh, dev),
            "local_a": _steps(prob, mesh, dev, args.steps)})
        del prob
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=900)
    ap.add_argument("--num-verts", type=int, default=10475)
    ap.add_argument("--scene-pts", type=int, default=100_489)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile_frames: no CUDA device available", file=sys.stderr)
        return 1
    out = {"device": None, "power_limit": None, "T": args.T,
           "mesh": MESH, "steps": args.steps}
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    if dev.type == "cuda":
        cand_cuda.build()
        chamfer_cuda.build()
    prob = standard_problem(T=args.T, num_verts=args.num_verts,
                            scene_pts=args.scene_pts, device=dev)
    for route in _routes(dev):
        prob.solver.step_graphs = route == "graph"
        t0 = time.perf_counter()
        prob.solver.fit(prob.body, prob.cam, mode="local")
        _sync(dev)
        out.setdefault(f"single_{route}", []).append({
            "seconds": time.perf_counter() - t0,
            "phases_s": dict(prob.solver.phase_seconds)})
    del prob
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(_rank, args=(os.path.join(d, "pg"), d,
                                                 args), nprocs=2, join=True)
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                out[f"rank{r}"] = json.load(f)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
