"""Reading the device from ``torch.profiler``: per-kernel device time,
the device's busy time over a window, and where it idled.

Only the profiler's raw events are read (``kineto_results.events()``),
never its event tree (which the profiler builds only when asked, or at
exit with ``acc_events``), so a solve of a million kernel launches is
read in seconds. A window's busy time is the union of every kernel's, copy's
and memset's interval on the device (work that overlaps counted once);
annotations are left out.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _raw(prof) -> list:
    return prof.profiler.kineto_results.events()


@contextlib.contextmanager
def _profile(acts):
    """A profiler over `acts`, quiet about its one cycle."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with profile(activities=acts) as prof:
            yield prof


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _device_acts() -> list:
    """The device's activity (the host's where no card is, to rehearse)."""
    return [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]


def _is_device(e) -> bool:
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation())


def union(intervals: np.ndarray) -> Tuple[float, np.ndarray]:
    """(length of the union of [start, end] rows, the merged rows)."""
    if len(intervals) == 0:
        return 0.0, intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            merged.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    merged.append((s, e))
    m = np.asarray(merged, dtype=np.float64)
    return float((m[:, 1] - m[:, 0]).sum()), m


def device_window(fn: Callable[[], None]) -> Dict:
    """fn() once under the profiler, device activity only -> the
    window's wall seconds (at least the span of the device's activity),
    the busy seconds, and each kernel's total device seconds and count."""
    with _profile(_device_acts()) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall = time.perf_counter() - t0
    kern: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    iv = []
    for e in _raw(prof):
        if not _is_device(e):
            continue
        s, d = e.start_ns(), e.duration_ns()
        iv.append((s, s + d))
        k = kern[e.name()]
        k[0] += d * 1e-9
        k[1] += 1
    iv = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    busy, merged = union(iv)
    span = (merged[-1, 1] - merged[0, 0]) if len(merged) else 0.0
    return {"window_s": max(wall, span * 1e-9), "busy_s": busy * 1e-9,
            "kernels": {k: (v[0], v[1]) for k, v in kern.items()}}


def breakdown(fn: Callable[[], None], top: int = 10) -> Dict:
    """fn() once under the profiler, host and device -> the device
    operations with the most device time, and the device's idle time
    inside the window by the innermost host operation running at each
    gap's middle ("host: python" where none ran), each [name, seconds],
    at most `top` of each."""
    with _profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    ops: Dict[str, float] = defaultdict(float)
    dev, host, names = [], [], []
    for e in _raw(prof):
        s, d = e.start_ns(), e.duration_ns()
        if _is_device(e):
            ops[e.name()[:120]] += d * 1e-9
            dev.append((s, s + d))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((s, s + d))
            names.append(e.name()[:120])
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    _, merged = union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    idle: Dict[str, float] = defaultdict(float)
    if len(merged) > 1 and host:
        h = np.asarray(host, dtype=np.float64)
        order = np.argsort(h[:, 0], kind="stable")
        h = h[order]
        nm = [names[i] for i in order]
        gaps = np.stack([merged[:-1, 1], merged[1:, 0]], 1)
        length = gaps[:, 1] - gaps[:, 0]
        keep = np.argsort(-length)[:20000]
        for g in keep:
            mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
            i = int(np.searchsorted(h[:, 0], mid, side="right")) - 1
            name = "host: python"
            for j in range(i, max(i - 64, -1), -1):
                if h[j, 1] >= mid:
                    name = nm[j]
                    break
            idle[name] += length[g] * 1e-9
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle_gaps]}
