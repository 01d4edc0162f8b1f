"""The clip solve's driver with the port's own trace: ``clip_solve``'s
set-up, window, profiled solves and check, and after those two profiled
solves, two more of the same clip under the profiler (host and device)
with the port's tracing on (``fpv4d_torch.utils.observability.tracing``):

* the span solve: spans and counters on, its graphs those of the
  untraced route; read by ``idle_s``, ``replay_gap_us``,
  ``kernels_per_step`` and ``device_allocs``;
* the section solve: the device section marks on too (marker kernels
  inside every replay, so its replays are not the untraced route's);
  read by ``section_s`` and ``refresh_ms``.

Each is kept as ``{"events": [...], "counts": {...}}``: the raw
profiler events that ``perfbench/metrics/_spans.py`` reads, and the
solver's ``trace_counts``. A port without the switch gives neither (their
metrics are then left out).
"""
from __future__ import annotations

import os
import sys
from typing import Dict

import torch
from torch.profiler import ProfilerActivity

from perfbench import profiling
from perfbench.drivers import clip_solve

# the two traced solves: (the record's key, device section marks on)
SOLVES = (("span_solve", False), ("section_solve", True))


def events(prof) -> list:
    """(name, kind, start_ns, end_ns, correlation) of the device's
    activity and of the host's program spans and graph launches."""
    out = []
    for e in profiling._raw(prof):
        name, s = sys.intern(e.name()), e.start_ns()
        if profiling._is_device(e):
            kind = "device"
        elif (e.device_type() == torch.autograd.DeviceType.CPU
              and (name.startswith("fpv4d") or name == "cudaGraphLaunch")):
            kind = "host"
        else:
            continue
        out.append((name, kind, s, s + e.duration_ns(), e.correlation_id()))
    return out


class Driver(clip_solve.Driver):
    def trace(self, solved: int) -> Dict:
        """``clip_solve``'s trace, then the span and section solves."""
        out = super().trace(solved)
        try:
            from fpv4d_torch.utils.observability import tracing
        except ImportError:
            return out
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if torch.cuda.is_available() else [])
        ck = os.path.join(self.work_dir, "traced")
        for key, sections in SOLVES:
            with tracing(on=True, sections=sections):
                with profiling._profile(acts) as prof:
                    self.solver.fit(self.session.bodies[solved],
                                    self.session.cams[solved],
                                    mode=self.mode, checkpoint_dir=ck)
                    profiling._sync()
            out[key] = {"events": events(prof),
                        "counts": dict(self.solver.trace_counts)}
        return out


def make(cfg: dict, workload: dict, seed: int, device, work_dir: str
         ) -> Driver:
    return Driver(cfg, workload, seed, device, work_dir)
