"""Reading the port's own trace (``fpv4d_torch.utils.observability``)
from the raw profiler events of the two traced solves that the
``clip_solve_traced`` driver adds: ``record["span_solve"]`` (spans and
counters on) and ``record["section_solve"]`` (device section marks on
too), each ``{"events": [...], "counts": {...}}``.

An event is a tuple (name, kind, start_ns, end_ns, correlation): kind
"device" for the card's kernels, copies and memsets, "host" for the
program's spans (``fpv4d.<name>``) and the host's ``cudaGraphLaunch``
calls. A marker kernel is named ``fpv4d_mark_<section>_<fwd|bwd>_<begin|
end>``; markers are never counted as activity.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

MARK = re.compile(r"fpv4d_mark_([a-z0-9]+)_(fwd|bwd)_(begin|end)")
SPAN = "fpv4d."


def solve(record, key: str) -> Optional[dict]:
    """The traced solve `key` of the record, or None."""
    got = record.get(key)
    return got if got and got.get("events") else None


def host_spans(events, prefix: str = SPAN) -> List[Tuple[str, int, int]]:
    """(name, start, end) of the host events whose name starts with
    `prefix`, in order of start."""
    return sorted(((n, s, e) for n, k, s, e, _ in events
                   if k == "host" and n.startswith(prefix)),
                  key=lambda t: t[1])


def span(events, name: str) -> Optional[Tuple[int, int]]:
    """(start, end) of the first span ``fpv4d.<name>``, or None."""
    for n, s, e in host_spans(events, SPAN + name):
        if n == SPAN + name:
            return s, e
    return None


def activity(events) -> np.ndarray:
    """[n, 2] start and end of every device event but the markers."""
    iv = [(s, e) for n, k, s, e, _ in events
          if k == "device" and not MARK.search(n)]
    return np.asarray(iv, dtype=np.float64).reshape(-1, 2)


def union(iv: np.ndarray) -> np.ndarray:
    """The union of [start, end] rows as sorted disjoint rows."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], 1)


def covered(merged: np.ndarray, a, b) -> np.ndarray:
    """The length of merged (sorted disjoint rows) inside each [a, b]."""
    a, b = np.atleast_1d(np.asarray(a, np.float64)), np.atleast_1d(
        np.asarray(b, np.float64))
    if len(merged) == 0:
        return np.zeros_like(a)
    cum = np.concatenate([[0.0], np.cumsum(merged[:, 1] - merged[:, 0])])

    def upto(t):
        # the length of merged before t
        i = np.searchsorted(merged[:, 0], t, side="right")
        part = np.clip(t - merged[np.maximum(i - 1, 0), 0], 0.0,
                       merged[np.maximum(i - 1, 0), 1]
                       - merged[np.maximum(i - 1, 0), 0])
        return cum[np.maximum(i - 1, 0)] + np.where(i > 0, part, 0.0)

    return np.maximum(upto(b) - upto(a), 0.0)


def minus(a: float, b: float, holes) -> np.ndarray:
    """[a, b] less the union of the (start, end) pairs `holes`, as
    sorted disjoint rows."""
    cut = union(np.clip(np.asarray(holes, np.float64).reshape(-1, 2), a, b))
    edges = np.concatenate([[a], cut.reshape(-1), [b]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def section_runs(events, section: str) -> List[Tuple[float, float]]:
    """The device intervals of one section: each maximal run of its
    markers of one direction (forward or backward) in the time order of
    every section's markers, from the end of the run's first marker to
    the start of its last (a section's backward may interleave its begin
    and end edges; another section's marker ends the run)."""
    marks = sorted((s, e, m.group(1), m.group(2))
                   for n, k, s, e, _ in events if k == "device"
                   for m in [MARK.search(n)] if m)
    runs, cur = [], None
    for s, e, sec, way in marks:
        if cur is not None and (sec, way) == cur[0]:
            cur[2] = s
            continue
        if cur is not None and cur[0][0] == section and cur[2] > cur[1]:
            runs.append((cur[1], cur[2]))
        cur = [(sec, way), e, e]
    if cur is not None and cur[0][0] == section and cur[2] > cur[1]:
        runs.append((cur[1], cur[2]))
    return runs


def section_seconds(record, section: str) -> Optional[Tuple[float, int]]:
    """(device seconds inside the section's runs in the section solve,
    the number of runs), or None where the solve has no marker of it."""
    got = solve(record, "section_solve")
    if got is None:
        return None
    runs = section_runs(got["events"], section)
    if not runs:
        return None
    merged = union(activity(got["events"]))
    a, b = np.asarray(runs, np.float64).T
    return float(covered(merged, a, b).sum()) * 1e-9, len(runs)


def idle_gaps(events) -> Optional[np.ndarray]:
    """[n, 2] the device's idle intervals inside the span ``fpv4d.fit``
    (before its first activity, between activities, after its last), or
    None where the solve has no fit span or no device activity."""
    fit = span(events, "fit")
    merged = union(activity(events))
    if fit is None or len(merged) == 0:
        return None
    a, b = fit
    inside = merged[(merged[:, 1] > a) & (merged[:, 0] < b)]
    inside = np.clip(inside, a, b)
    edges = np.concatenate([[a], inside.reshape(-1), [b]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def innermost(events, points: np.ndarray) -> List[Optional[str]]:
    """The innermost program span (the latest to start of those holding
    it) at each of `points`, or None."""
    spans = host_spans(events)              # in order of start
    label = np.full(len(points), -1)
    order = np.argsort(points, kind="stable")
    sp = points[order]
    for i, (_, s, e) in enumerate(spans):
        label[order[np.searchsorted(sp, s, side="left"):
                    np.searchsorted(sp, e, side="right")]] = i
    return [spans[i][0] if i >= 0 else None for i in label]
