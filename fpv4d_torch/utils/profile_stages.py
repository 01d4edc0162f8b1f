"""Wall and device time of the per-frame stages on the card, on both
routes.

    python -m fpv4d_torch.utils.profile_stages [--T 900] [--clips 8]
        [--seq-T 50]

On the standard problem's model and VPoser weights, runs the Adam
keypoint fit of ``keypoint_problem`` at T frames, the same fit batched
over C clips (1 px of noise each), the joint and the per-frame L-BFGS
fits at T frames (with each iteration's line-search rounds, mean and
max), and the three smoothers on the Adam fit's
result (``fit_independent`` at T frames, ``fit_sequential`` and
``fit_sequential_motion`` at its first --seq-T frames), each on the
graph route and then on the eager one (``step_graphs=False``). Each run
once to warm, once timed on the host clock around a synchronised window
(its captures included, as a caller pays them), and once under
torch.profiler (device activity only: a graph's replayed kernels are
seen), whose kernel and copy times are summed into the device seconds;
the busy share is that profiled run's time with some kernel or copy
running (overlaps counted once) over its own wall time. It prints one
JSON object: the card's name and power limit and, per stage and route,
wall seconds, device seconds, the busy share and kernels per run; each
stage's record goes to stderr as it is measured.

Exits non-zero without a CUDA device unless ``--device cpu`` is given (a
rehearsal of the control flow at a small size, eager only: no device
numbers).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from fpv4d_torch.config import KeypointFitConfig
from fpv4d_torch.models import motion_gru, vposer
from fpv4d_torch.solve import frame_fit
from fpv4d_torch.solve import keypoint_fit
from fpv4d_torch.solve.keypoint_fit import fit_keypoints
from fpv4d_torch.utils.bench_problem import (cached_synthetic_model,
                                             default_cache_dir,
                                             keypoint_problem)
from fpv4d_torch.utils.profile_local import (_kernel_times, _sync,
                                              profiled)


def measure(fn, dev: torch.device) -> dict:
    """Wall seconds of one run of fn() after one to warm; on the card,
    the device seconds, busy share and kernels of one more run."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    rec = {"wall_s": wall, "device_s": None, "busy_share": None,
           "kernels": None}
    if dev.type != "cuda":
        return rec
    prof, window_us, busy_us = profiled(fn, dev)
    ks = _kernel_times(prof)
    dev_s = sum(us for _, us, _ in ks) / 1e6
    rec.update(device_s=dev_s, busy_share=busy_us / window_us,
               kernels=sum(c for _, _, c in ks))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=900)
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--seq-T", type=int, default=50)
    ap.add_argument("--iters", type=int, default=120,
                    help="Adam steps per keypoint stage")
    ap.add_argument("--lbfgs-iters", type=int, default=60,
                    help="joint L-BFGS iterations per keypoint stage")
    ap.add_argument("--perframe-iters", type=int, default=40,
                    help="per-frame L-BFGS iterations per keypoint stage")
    ap.add_argument("--num-verts", type=int, default=10475)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile_stages: no CUDA device available", file=sys.stderr)
        return 1

    model = cached_synthetic_model(args.num_verts, default_cache_dir(),
                                   device=dev)
    vp = vposer.random_params(seed=0, device=dev)
    kp, cfg = keypoint_problem(model, vp, args.T, num_iter=args.iters)
    kp_b = np.broadcast_to(kp, (args.clips,) + kp.shape).copy()
    kp_b[..., :2] += np.random.RandomState(2).randn(
        *kp_b[..., :2].shape).astype(np.float32)
    body, _ = fit_keypoints(model, vp, kp, cfg, device=dev)
    gru = motion_gru.random_params(0, device=dev)
    seq = body[:args.seq_T]
    T, C, S = args.T, args.clips, len(seq)
    stages = {
        f"keypoints adam T={T}": lambda g: fit_keypoints(
            model, vp, kp, cfg, device=dev, step_graphs=g),
        f"keypoints batched {C} x {T}": lambda g: fit_keypoints(
            model, vp, kp_b, KeypointFitConfig(num_iter=args.iters),
            device=dev, step_graphs=g),
        f"keypoints lbfgs T={T}": lambda g: fit_keypoints(
            model, vp, kp, KeypointFitConfig(num_iter=args.lbfgs_iters,
                                             optimizer="lbfgs"),
            device=dev, step_graphs=g),
        f"keypoints lbfgs_perframe T={T}": lambda g: fit_keypoints(
            model, vp, kp, KeypointFitConfig(num_iter=args.perframe_iters,
                                             optimizer="lbfgs_perframe"),
            device=dev, step_graphs=g),
        f"fit_independent T={T}": lambda g: frame_fit.fit_independent(
            body, device=dev, step_graphs=g),
        f"fit_sequential T={S}": lambda g: frame_fit.fit_sequential(
            seq, device=dev, step_graphs=g),
        f"fit_sequential_motion T={S}": lambda g: frame_fit.
        fit_sequential_motion(seq, gru, device=dev, step_graphs=g),
    }
    out = {"device": None, "power_limit": None}
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    routes = {"graph": True, "eager": False} if dev.type == "cuda" \
        else {"eager": False}
    for name, fn in stages.items():
        out[name] = {r: measure(lambda: fn(g), dev)
                     for r, g in routes.items()}
        if "lbfgs" in name:
            rounds = [n for v in keypoint_fit.lbfgs_rounds.values()
                      for n in v]
            for rec in out[name].values():
                rec.update(rounds_mean=float(np.mean(rounds)),
                           rounds_max=int(max(rounds)))
        print(f"[profile_stages] {name}: {json.dumps(out[name])}",
              file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
