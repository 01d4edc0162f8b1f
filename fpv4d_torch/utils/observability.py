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
    before the clock stops;
  * the program's own trace, on one switch, `tracing(on, sections)`:
    `span(name)`, a ``torch.profiler.record_function`` range named
    ``fpv4d.<name>`` (on the profiler's clock, the clock of the device
    activity in the same trace); `count(name, n)`, an in-memory counter
    (``ClipSolver.fit`` resets them and keeps them as its
    ``trace_counts``), among them each hand-written kernel's route,
    ``<k>/cuda`` at each launch and ``<k>/plain`` at each call of its
    plain version (k1, k2, skin, adam), which solve/step_graph.py counts
    through a captured graph's replays; and with ``sections=True`` the device section
    marks `mark(section, x)` and `section(name, device)`: one-thread
    marker kernels (csrc/mark.cu) named ``fpv4d_mark_<section>_<edge>``,
    launched inside the step, so a captured CUDA graph holds them and
    every replay's device trace shows where each section's forward and
    backward begin and end. With tracing off (the default) every site
    costs one test of a module-level flag and does nothing else.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

# -- the program's own trace ------------------------------------------------

# whether spans and counters are recorded, and whether section marks are
# made (set only by `tracing`; every site tests one of them)
spans_on = False
sections_on = False
# the counters since the last `reset_counts`
_counts: Dict[str, int] = {}
# whether a `counted_apart` context is open (its counts are kept whatever
# `spans_on` is)
_apart = False
# the sections a mark may name and the edges of each, in the order of
# csrc/mark.cu's kernels
SECTIONS = ("vposer", "blend", "fk", "skin", "contact", "losses", "adam",
            "refresh")
EDGES = ("fwd_begin", "fwd_end", "bwd_begin", "bwd_end")
_MARKS = {(s, e): i * len(EDGES) + j for i, s in enumerate(SECTIONS)
          for j, e in enumerate(EDGES)}
_NULL = contextlib.nullcontext()
_marker = None          # csrc/mark.cu's C entry point, once built
# each section's inputs' gradient edges, from its begin mark to its end
_open: Dict[str, list] = {}
# the sequence number of a leaf's gradient accumulator (the largest)
_LEAF_SEQ = 2 ** 63


def _load_marker():
    """Build (if not built for this source) and load the marker kernels."""
    global _marker
    if _marker is None:
        from fpv4d_torch.ops import cuda_build
        _marker, _ = cuda_build.load_function(
            cuda_build.CSRC / "mark.cu", "fpv4d_mark",
            [cuda_build.INT, cuda_build.POINTER])
    return _marker


@contextlib.contextmanager
def tracing(on: bool = True, sections: bool = False):
    """Spans and counters on inside the context (`on`), and with
    `sections` the device section marks too; the previous setting after
    it. Entering with sections on a machine with a card builds the
    marker kernels first (nothing builds them at import or with tracing
    off).

    The switch is read where a site runs: a captured CUDA graph keeps
    the marks of the setting it was captured under, and each replay of
    it launches them whatever the setting is then. ``ClipSolver.fit``
    keeps its graphs across fits under a signature that holds the
    section-marks switch, so a fit with the other setting captures
    anew."""
    global spans_on, sections_on
    sections = bool(on and sections)
    if sections and torch.cuda.is_available():
        _load_marker()
    prev = spans_on, sections_on
    spans_on, sections_on = bool(on), sections
    try:
        yield
    finally:
        spans_on, sections_on = prev


def span(name: str):
    """A profiler range ``fpv4d.<name>`` while tracing is on (a context
    that does nothing otherwise)."""
    if not spans_on:
        return _NULL
    return torch.profiler.record_function(f"fpv4d.{name}")


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while tracing is on, or inside
    `counted_apart` whatever the setting."""
    if spans_on or _apart:
        _counts[name] = _counts.get(name, 0) + n


def reset_counts() -> None:
    _counts.clear()


@contextlib.contextmanager
def counted_apart():
    """The counts made inside the context, with tracing on or off, kept
    out of the counters and yielded: a dict that holds them on exit (what
    a CUDA graph's capture, which runs nothing, would have counted; each
    replay adds it while tracing is on)."""
    global _counts, _apart
    outer, _counts = _counts, {}
    was, _apart = _apart, True
    apart: Dict[str, int] = {}
    try:
        yield apart
    finally:
        apart.update(_counts)
        _counts, _apart = outer, was


def counts() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_counts)


def _emit(section: str, edge: str, device: torch.device) -> None:
    """One marker: on a CUDA device a marker kernel on the current
    stream (captured into a graph when the stream is capturing); off the
    card a zero-length host range of the same name."""
    which = _MARKS.get((section, edge))
    if which is None:
        raise ValueError(f"no section mark {section!r} ({edge}): the "
                         f"sections are {SECTIONS}")
    if device.type == "cuda":
        err = _load_marker()(which,
                             torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"section marker launch failed: CUDA error "
                               f"{err}")
    else:
        with torch.profiler.record_function(
                f"fpv4d_mark_{section}_{edge}"):
            pass


def _grad_consumers(roots, edges) -> list:
    """The autograd nodes between `roots` (a section's outputs' nodes)
    and `edges` (its inputs' gradient edges) that take one of those
    edges' gradients: the last of the section's backward to run for each
    input. The walk stops at the inputs and at nodes made before them."""
    want = {(id(e.node), e.output_nr) for e in edges}
    keep = [e.node for e in edges]     # their ids stay theirs meanwhile
    floor = max((n._sequence_nr() for n in keep
                 if n._sequence_nr() < _LEAF_SEQ), default=-1)
    found, seen, todo = [], set(), list(roots)
    while todo:
        n = todo.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        keep.append(n)
        hit = False
        for nxt, nr in n.next_functions:
            if nxt is None:
                continue
            if (id(nxt), nr) in want:
                hit = True
            elif floor < nxt._sequence_nr() < _LEAF_SEQ:
                todo.append(nxt)
        if hit:
            found.append(n)
    return found


def mark(section: str, x, end: bool = False):
    """`x` (a tensor, or a tuple of tensors and Nones) itself, marking
    the beginning of `section` at its inputs `x` (its end at its outputs
    `x` with `end`) while section marks are on: the forward edge's
    marker at once, and where a gradient flows, the backward edges'
    markers from autograd hooks. The backward begins as each output's
    gradient reaches the node that made it (a tensor hook) and ends as
    each node that takes an input's gradient has run (a node hook); mark
    every input whose gradient the section computes in one call, and
    every output in one. Hooks change neither the graph nor the order in
    which autograd sums a tensor's gradient, so a marked solve computes
    the same bits (an identity node on the gradient's path would regroup
    those sums). With marks off, `x` and nothing else."""
    if not sections_on:
        return x
    xs = [t for t in ((x,) if isinstance(x, torch.Tensor) else x)
          if t is not None]
    if not xs:
        return x
    dev = xs[0].device
    _emit(section, "fwd_end" if end else "fwd_begin", dev)
    grads = ([t for t in xs if t.requires_grad]
             if torch.is_grad_enabled() else [])
    if not end:
        _open[section] = [torch.autograd.graph.get_gradient_edge(t)
                          for t in grads]
        return x
    edges = _open.pop(section, [])
    if grads and edges:
        for y in grads:
            y.register_hook(lambda g: _emit(section, "bwd_begin", dev))
        for n in _grad_consumers([y.grad_fn for y in grads
                                  if y.grad_fn is not None], edges):
            n.register_hook(lambda gi, go: _emit(section, "bwd_end", dev))
    return x


class _Section:
    def __init__(self, name: str, device):
        self.name, self.device = name, torch.device(device)

    def __enter__(self):
        _emit(self.name, "fwd_begin", self.device)

    def __exit__(self, *exc):
        _emit(self.name, "fwd_end", self.device)
        return False


def section(name: str, device):
    """A section through which no gradient flows (an optimizer step, a
    refresh under no_grad): its begin and end marks on `device` around
    the context while section marks are on (a context that does nothing
    otherwise)."""
    if not sections_on:
        return _NULL
    return _Section(name, device)


@contextlib.contextmanager
def trace(log_dir: str, sections: bool = False):
    """Profile everything inside the context, with the program's spans on
    (`tracing`; with `sections`, its device section marks too); on exit,
    write its Chrome trace to ``<log_dir>/trace.json``. Yields that
    path."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with tracing(on=True, sections=sections):
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
