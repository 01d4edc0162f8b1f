"""Tracing, profiling and numeric-anomaly debugging (port of
fpv4d/utils/observability.py).

The reference's own observability is print() lines and
torch.autograd.set_detect_anomaly(True) around every step
(global_optimization.py:502,514-516; SURVEY.md section 5). Here:
  * `trace(log_dir)`: a torch.profiler run (CPU, and CUDA when a card
    is present) whose Chrome trace is written to
    ``<log_dir>/trace.json``, kernel names included;
  * `debug_nans(enable)` / `nan_debugging()`: autograd's anomaly mode,
    which names the backward function that produced a NaN;
  * `checked(fn, *args)`: run fn and raise FloatingPointError on a
    non-finite floating output;
  * `StageTimer`: wall seconds per named stage, the card synchronised
    before the clock stops.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the context; on exit, write its Chrome
    trace to ``<log_dir>/trace.json``. Yields that path."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off: a backward that produces
    a NaN then raises, naming the function and the forward's stack (the
    analogue of jax_debug_nans)."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def nan_debugging():
    """Anomaly mode inside the context; the previous setting after it."""
    prev = torch.is_anomaly_enabled()
    debug_nans(True)
    try:
        yield
    finally:
        debug_nans(prev)


def _floating_tensors(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _floating_tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _floating_tensors(v)


def checked(fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` and return its result; raise
    FloatingPointError if any floating tensor in it (nested in tuples,
    lists or dicts) holds a NaN or an infinity. An index out of range
    or an integer division by zero raises in torch itself (IndexError,
    RuntimeError) and propagates. On the card, an out-of-range index
    is a device-side assert that poisons the CUDA context instead."""
    out = fn(*args, **kwargs)
    for i, t in enumerate(_floating_tensors(out)):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"{getattr(fn, '__name__', fn)}: output tensor {i} "
                f"{tuple(t.shape)} holds a non-finite value")
    return out


@dataclass
class StageTimer:
    """Wall seconds per named stage. With `sync_on` (a tensor), the
    card it lies on is synchronised before the clock stops, so the
    device work queued in the stage is counted in it."""
    records: Dict[str, List[float]] = field(default_factory=dict)
    verbose: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None and sync_on.device.type == "cuda":
                torch.cuda.synchronize(sync_on.device)
            dt = time.perf_counter() - t0
            self.records.setdefault(name, []).append(dt)
            if self.verbose:
                print(f"[fpv4d_torch.timer] {name}: {dt:.3f}s")

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self.records.items()}
