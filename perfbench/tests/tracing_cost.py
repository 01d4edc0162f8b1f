"""The port's own trace in one cell on the card, outside the benchmark:
what tracing costs, whether it keeps the bits, and every reader of the
traced solves with the numbers that hold them to the device trace.

    python3 -m perfbench.tests.tracing_cost --workload local-grid \\
        --seed 2147490031

After the cell's warm-up, solves clip 0 nine times in turns, tracing
off, spans on, marks on (off, spans, sections, sections, spans, off,
...; no profiler), each a whole ``fit`` with its checkpoints; then the
``clip_solve_traced`` driver's trace of clip 0. One JSON line: the
solves' seconds by setting, whether each setting's histories and final
states equal tracing off's, every reader of the span and section
solves (``section_s``, ``refresh_ms``, ``idle_s``, ``replay_gap_us`` and
``kernels_per_step`` of every phase, ``device_allocs``), and the
consistency numbers: the section solve's busy seconds and the sections'
sum, K1's, K2's and the Adam's (``multi_tensor_apply``) kernel seconds
in it, each phase's replays beside its graph launches, and the span
solve's idle seconds with the idle under each innermost span.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
ORDER = ("off", "spans", "sections", "sections", "spans", "off", "off",
         "spans", "sections")
PHASES = ("local_a", "local_b", "global_a", "global_b", "dct_a", "dct_b")


def _kernel_s(events, key: str) -> float:
    return 1e-9 * sum(e - s for n, k, s, e, _ in events
                      if k == "device" and key in n)


def main(argv=None) -> int:
    from fpv4d_torch.utils import observability as OBS
    from perfbench import run
    from perfbench.drivers import clip_solve_traced as T
    from perfbench.metrics import _spans as S
    from perfbench.reference.prec import f32_products
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tracing_cost: no CUDA device", file=sys.stderr)
        return 1
    f32_products()
    wl, cfg = run.load_cell(args.workload)
    d = T.make(cfg, wl, args.seed, "cuda", tempfile.mkdtemp())
    d.warm()
    sv, ses = d.solver, d.session
    secs, runs = {}, {}
    for how in ORDER:
        ctx = (contextlib.nullcontext() if how == "off"
               else OBS.tracing(on=True, sections=how == "sections"))
        with ctx:
            t0 = time.perf_counter()
            st, hist = sv.fit(ses.bodies[0], ses.cams[0], mode=d.mode,
                              checkpoint_dir=os.path.join(d.work_dir, "c"))
            torch.cuda.synchronize()
            secs.setdefault(how, []).append(time.perf_counter() - t0)
        runs.setdefault(how, []).append((hist, [x.clone() for x in st]))
    h0, s0 = runs["off"][0]
    equal = {how: all(all(np.array_equal(h[k], h0[k]) for k in h0)
                      and all(torch.equal(a, b) for a, b in zip(st, s0))
                      for h, st in rs) for how, rs in runs.items()}
    rec = d.trace(0)
    names = (["section_s." + x for x in OBS.SECTIONS if x != "refresh"]
             + ["refresh_ms", "idle_s.capture", "idle_s.checkpoint",
                "idle_s.init", "device_allocs"]
             + [f"{m}.{p}" for m in ("replay_gap_us", "kernels_per_step")
                for p in PHASES])
    metrics = {n: run.read_metric(n, rec) for n in names}
    ev = rec["section_solve"]["events"]
    fit = S.span(ev, "fit")
    busy = 1e-9 * float(S.covered(S.union(S.activity(ev)), *fit).sum())
    sections = {x: (S.section_seconds(rec, x) or (0.0, 0))[0]
                for x in OBS.SECTIONS}
    sev, counts = rec["span_solve"]["events"], rec["span_solve"]["counts"]
    gaps = S.idle_gaps(sev)
    idle_by = {}
    for n, g in zip(S.innermost(sev, gaps.mean(axis=1)),
                    gaps[:, 1] - gaps[:, 0]):
        idle_by[n] = idle_by.get(n, 0.0) + 1e-9 * float(g)
    refresh = [(a, b) for _, a, b in S.host_spans(sev, "fpv4d.refresh/")]
    launches = {}
    for key, n in counts.items():
        if key.startswith("replays/"):
            ph = key.split("/", 1)[1]
            a, b = S.span(sev, "phase/" + ph) or S.span(
                sev, "phase/local_" + ph)
            launches[ph] = [n, sum(
                1 for m, k, s, e, _ in sev
                if k == "host" and m == "cudaGraphLaunch" and a <= s <= b
                and not any(x <= s <= y for x, y in refresh))]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0), "seconds": secs,
        "bit_equal": equal, "metrics": metrics,
        "section_busy_s": busy, "sections_s": sections,
        "coverage": sum(sections.values()) / busy,
        "kernel_s": {k: _kernel_s(ev, k) for k in (
            "cand_nn_kernel", "chamfer_nn_kernel", "multi_tensor_apply")},
        "replays_and_launches": launches,
        "span_idle_s": 1e-9 * float((gaps[:, 1] - gaps[:, 0]).sum()),
        "idle_by_span": idle_by}), flush=True)
    d.close()
    return 0


if __name__ == "__main__":
    sys.path[:] = [q for q in sys.path
                   if Path(q or ".").resolve() != ROOT / "perfbench" / "tests"]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
