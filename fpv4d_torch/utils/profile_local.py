"""Per-step profile of the local-mode clip solve on the card.

    python -m fpv4d_torch.utils.profile_local [--steps 20]

Builds the standard problem at full size, seeds the state and the one
Adam state as ``ClipSolver.fit`` does, and measures each unit of the
local-mode solve in turn: a candidate-table refresh, a local_a step
(contact against the refreshed tables), a local_b step and a skate
step. The units run as the solver's fit runs them (one phase program:
on the card each phase's step and the refresh captured once as a CUDA
graph and replayed; ``--eager`` runs them eagerly), and the refresh
also eagerly ("refresh eager"), so one run reports it on both routes.
For each unit it times
``--steps`` runs on the host clock around a synchronised window, then
profiles ``--steps`` more with torch.profiler and sums the device time
of every kernel, those inside a graph's replays included. The busy
share is taken in that profiled window alone: the time in which some
kernel or copy ran (overlaps counted once) over the window's wall
time, so it never exceeds 1. It prints one JSON object: the card's
name and power limit, the route and, per unit, wall ms, device ms,
busy ms, the profiled window's ms and the busy share per run, K1's
device ms per run, kernels run per run and the kernels with the most
device time.

Exits non-zero without a CUDA device unless ``--device cpu`` is given
(a rehearsal of the control flow at a small size: no device numbers).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from fpv4d_torch.solve.clip_solve import refresh_contact
from fpv4d_torch.utils.bench_problem import standard_problem


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_times(prof):
    """(name, total device us, count) of every kernel and copy on the
    device (annotated ranges, such as Optimizer.step, overlap them and
    are left out)."""
    out = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, float(us), int(e.count)))
    return sorted(out, key=lambda r: -r[1])


def busy_span(spans) -> tuple[float, float]:
    """(busy, span) of device activity given as (start, end) intervals:
    busy is the length of their union (work that overlaps counts once),
    span the distance from the first start to the last end."""
    busy, end, first = 0.0, float("-inf"), None
    for s, e in sorted(spans):
        first = s if first is None else first
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, (0.0 if first is None else end - first)


def _device_spans(prof):
    """(start, end) in us of every kernel and copy on the device, the
    events _kernel_times sums."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profiled(fn, dev: torch.device):
    """fn() once under torch.profiler (device activity only):
    (the profile, the window's wall us, its busy us). The window is at
    least the span of the device activity it saw, so busy <= window."""
    # the device's activity alone: every number here is a kernel's or a
    # copy's, and the host's op events would multiply what the profiler
    # records and key_averages() sorts
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        window_us = (time.perf_counter() - t0) * 1e6
    busy_us, span_us = busy_span(_device_spans(prof))
    return prof, max(window_us, span_us), busy_us


def measure(fn, steps: int, dev: torch.device, top: int = 6) -> dict:
    """Wall and device time per run of fn(n) (which runs n units). On a
    phase program's graph route the warm-up captures the graph, and the
    windows replay it; where the profiler shows fewer than 2 kernels a
    run (a replay's kernels unseen), the device numbers are None and
    ``seen`` is False."""
    fn(3)                                          # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    fn(steps)
    _sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rec = {"wall_ms": wall_ms, "device_ms": None, "busy_ms": None,
           "window_ms": None, "busy_share": None, "k1_ms": None,
           "launches": None, "top": None, "seen": None}
    if dev.type != "cuda":
        return rec
    prof, window_us, busy_us = profiled(lambda: fn(steps), dev)
    ks = _kernel_times(prof)
    if sum(c for _, _, c in ks) < 2 * steps:
        rec["seen"] = False
        return rec
    dev_ms = sum(us for _, us, _ in ks) / 1e3 / steps
    k1_us = sum(us for k, us, _ in ks if "cand_nn_kernel" in k)
    rec.update(seen=True, device_ms=dev_ms, busy_ms=busy_us / 1e3 / steps,
               window_ms=window_us / 1e3 / steps,
               busy_share=busy_us / window_us,
               k1_ms=k1_us / 1e3 / steps,
               launches=sum(c for _, _, c in ks) / steps,
               top=[{"kernel": k[:96], "ms": us / 1e3 / steps,
                     "per_step": c / steps} for k, us, c in ks[:top]])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=900)
    ap.add_argument("--num-verts", type=int, default=10475)
    ap.add_argument("--scene-pts", type=int, default=100_489)
    ap.add_argument("--eager", action="store_true",
                    help="run the steps eagerly on the card (no graphs)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile_local: no CUDA device available", file=sys.stderr)
        return 1

    prob = standard_problem(T=args.T, num_verts=args.num_verts,
                            scene_pts=args.scene_pts, device=dev)
    s = prob.solver
    if args.eager:
        s.step_graphs = False
    state, target, fw = s.init_state(prob.body, prob.cam)
    state, opt = s.make_optimizer(state)
    weight_right = s.detect_contact(state)
    program = s.program()

    def refresh(n):
        for _ in range(n):
            cands = refresh_contact(program, ("local_a", True, False),
                                    lambda out: s._refresh_cands(state,
                                                                 out))[0]
        return cands

    def refresh_eager(n):
        for _ in range(n):
            s._refresh_cands(state)

    cands = refresh(1)
    units = {
        "refresh": refresh,
        "refresh eager": refresh_eager,
        "local_a": lambda n: s._run_phase(state, opt, target, fw, n,
                                          "local_a", cands, program=program),
        "local_b": lambda n: s._run_phase(state, opt, target, fw, n,
                                          "local_b", program=program),
        "local_skate": lambda n: s._run_skate_phase(
            state, opt, target, fw, n, weight_right, program),
    }
    out = {"device": None, "power_limit": None,
           "step_graphs": program.graphs, "T": args.T,
           "contact_vertices": len(s.contact_vids),
           "P": int(cands.cand.shape[1]), "steps": args.steps}
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    for name, fn in units.items():
        out[name] = measure(fn, args.steps, dev)
    out["capture_s"] = {" ".join(map(str, k)): v
                        for k, v in program.capture_seconds.items()}
    program.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
