"""The readings that the check's limit is set from, on the card at a
cell's own size: for each seed, a session and a solver as a run builds
them, ``--clips`` solves of the cell's mode, and per solve the loss gap
of each phase and step (the program against the float32 reference), and
on the first ``--control`` seeds also the control's (the reference in
TF32 put in the program's place). With ``--fault replay`` the program's
replays run no Adam update (``faults.replays_leave_the_state``): the
fault's readings. One JSON line per solve.

    python3 -m perfbench.tests.readings --workload local-grid \\
        --seeds 3001-3012 --control 4 --clips 2
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def seeds_of(text: str):
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def per_step(prog, ref):
    """Per phase, each step's relative gap."""
    return {k: [abs(p - r) / max(abs(r), 1e-30)
                for p, r in zip(list(prog[k])[:len(v)], v)]
            for k, v in ref.items()}


def main(argv=None) -> int:
    from perfbench import run
    from perfbench.reference import check as REF
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("none", "replay"), default="none")
    args = ap.parse_args(argv)
    wl, cfg = run.load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 1
    from perfbench.drivers import clip_solve as D
    from perfbench.reference.prec import f32_products
    from perfbench.tests import faults
    f32_products()
    for k, seed in enumerate(seeds_of(args.seeds)):
        t0 = time.time()
        d = D.make(cfg, wl, seed, args.device, tempfile.mkdtemp())
        with (faults.replays_leave_the_state() if args.fault == "replay"
              else contextlib.nullcontext()):
            for i in range(args.clips):
                d.solve(i)
        p = d.problem()
        for i in range(args.clips):
            s = d.session
            ref = REF.reference_losses(p, d.mode, s.bodies[i], s.cams[i],
                                       d._ckpt(i))
            prog = {n: [float(x) for x in v[:REF.STEPS]]
                    for n, v in d.hists[i].items()}
            line = {"workload": args.workload, "seed": seed, "clip": i,
                    "fault": args.fault,
                    "numbers": REF.numbers(prog, ref),
                    "program": per_step(prog, ref)}
            if k < args.control:
                ctl = REF.reference_losses(p, d.mode, s.bodies[i],
                                           s.cams[i], d._ckpt(i), "tf32")
                line["control_numbers"] = REF.numbers(ctl, ref)
                line["control"] = per_step(ctl, ref)
            line["seconds"] = time.time() - t0
            print(json.dumps(line), flush=True)
        d.close()
        del d, p
    return 0


if __name__ == "__main__":
    sys.path[:] = [q for q in sys.path
                   if Path(q or ".").resolve() != ROOT / "perfbench" / "tests"]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
