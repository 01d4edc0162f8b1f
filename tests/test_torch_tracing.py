"""The port's own trace (fpv4d_torch/utils/observability.py: `tracing`,
`span`, `count`, `mark`, `section`) around the clip solve, at T = 12 on
the CPU, on the eager route and on the graph route with a stand-in
capture whose replay reruns the step:

* tracing off: a profiled solve holds no ``fpv4d`` event, no counter,
  and no mark is made, captured or not;
* spans on, and spans with section marks: the loss histories and the
  final state bit-equal to tracing off, on both routes (the marks hang
  on autograd hooks, never on the gradient's path);
* every ``phase/*``, ``checkpoint``, ``capture/*``, ``warmup/*`` and
  ``refresh/*`` span lies inside the one ``fit`` span, and the
  ``phase/*`` spans are the stages of ``phase_seconds``;
* the counter ``replays/<phase>`` is the phase's steps less its warm-ups;
* each section's forward marks come in begin/end pairs, and its
  backward marks in runs that open with a begin and close with an end,
  one section's run never inside another's, and a traced CPU solve
  skins on the plain route only (``skin/plain``);
* the marker kernels' source names the sections the module knows;
* on the card (`gpu`), the graph route with spans and with marks
  bit-equal to tracing off, and the marks captured into the replays.
"""
import dataclasses
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fpv4d_torch.ops import cuda_build
from fpv4d_torch.solve import step_graph
from fpv4d_torch.utils import observability as OBS
from fpv4d_torch.utils.bench_problem import standard_problem

MARK = re.compile(r"fpv4d_mark_([a-z0-9]+)_(fwd|bwd)_(begin|end)")

# (nn_impl, mode, standard_problem's skate_subset): every mode, K2 and
# the grid's refreshed tables, the skate on a subset and on the full mesh
CASES = {"local-grid": ("grid", "local", 64),
         "local-brute": ("brute", "local", 0),
         "global-brute": ("brute", "global", 64),
         "dct-grid": ("grid", "dct", 64)}


class RerunCapture:
    """Records the step as a capture does (nothing runs); each replay
    reruns it."""

    def __init__(self, step, pool, stream):
        self.step = step
        self.out = None

    def replay(self):
        self.out = self.step()


def _problem(case, device="cpu"):
    nn_impl, mode, skate = CASES[case]
    prob = standard_problem(T=12, num_verts=256, scene_pts=400, num_iter=12,
                            num_iter_dct=24, skate_subset=skate,
                            contact_compact=32, nn_impl=nn_impl,
                            device=device)
    prob.solver.config = dataclasses.replace(
        prob.solver.config, window=12, contact_refresh_steps=3)
    return prob, mode


def _route(solver, graphs):
    """The solver's programs on the graph route with the stand-in
    capture (graphs) or eager, its kept program dropped: the next fit
    makes one and, on the graph route, captures."""
    solver.close()
    solver.program = (
        (lambda: step_graph.PhaseProgram("cpu", True, RerunCapture))
        if graphs else (lambda: step_graph.eager("cpu")))


@pytest.fixture(scope="module")
def untraced():
    """Each case's problem and its untraced solve on either route."""
    out = {}
    for case in CASES:
        prob, mode = _problem(case)
        for graphs in (False, True):
            _route(prob.solver, graphs)
            out[case, graphs] = prob, mode, prob.solver.fit(
                prob.body, prob.cam, mode=mode)
    return out


def _fit(prob, mode, graphs, on, sections, ckpt=None):
    """A profiled solve under `tracing(on, sections)` -> (state, history,
    the ``fpv4d`` host events as (name, start, end) in order of start)."""
    _route(prob.solver, graphs)
    with OBS.tracing(on=on, sections=sections):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, hist = prob.solver.fit(prob.body, prob.cam, mode=mode,
                                          checkpoint_dir=ckpt)
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith("fpv4d")]
    return state, hist, sorted(ev, key=lambda t: t[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_off_records_nothing(case, untraced, monkeypatch):
    prob, mode, _ = untraced[case, True]
    made = []
    monkeypatch.setattr(OBS, "_emit", lambda *a: made.append(a))
    _, _, ev = _fit(prob, mode, True, on=False, sections=False)
    assert ev == [] and made == []
    assert prob.solver.trace_counts == {}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("sections", [False, True],
                         ids=["spans", "sections"])
def test_traced_solve_is_bit_equal(case, graphs, sections, untraced):
    prob, mode, (state0, hist0) = untraced[case, graphs]
    _route(prob.solver, graphs)
    with OBS.tracing(on=True, sections=sections):
        state, hist = prob.solver.fit(prob.body, prob.cam, mode=mode)
    assert hist.keys() == hist0.keys()
    for k in hist0:
        assert np.array_equal(hist[k], hist0[k]), k
    for a, b in zip(state, state0):
        assert torch.equal(a, b)
    assert prob.solver.trace_counts or not graphs


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_lie_inside_fit(case, untraced, tmp_path):
    prob, mode, _ = untraced[case, True]
    _, _, ev = _fit(prob, mode, True, True, False, str(tmp_path))
    fits = [(s, e) for n, s, e in ev if n == "fpv4d.fit"]
    assert len(fits) == 1
    a, b = fits[0]
    spans = [(n, s, e) for n, s, e in ev if n != "fpv4d.fit"]
    kinds = {n.split("/")[0] for n, _, _ in spans}
    assert {"fpv4d.phase", "fpv4d.checkpoint", "fpv4d.capture",
            "fpv4d.warmup"} <= kinds
    assert all(a <= s <= e <= b for _, s, e in spans)
    phases = [n[len("fpv4d.phase/"):] for n, _, _ in spans
              if n.startswith("fpv4d.phase/")]
    assert phases == list(prob.solver.phase_seconds)
    if prob.solver.nn_impl == "grid" or mode == "local":
        assert "fpv4d.refresh" in kinds


@pytest.mark.parametrize("case", sorted(CASES))
def test_replays_count_steps_less_warmups(case, untraced):
    prob, mode, (_, hist0) = untraced[case, True]
    _route(prob.solver, True)
    with OBS.tracing():
        prob.solver.fit(prob.body, prob.cam, mode=mode)
    counts = prob.solver.trace_counts
    want = {("skate" if k == "local_skate" else k):
            len(v) - step_graph.WARMUP_STEPS for k, v in hist0.items()
            if len(v) > step_graph.WARMUP_STEPS}
    assert {k[len("replays/"):]: v for k, v in counts.items()
            if k.startswith("replays/")} == want
    # eager, nothing is replayed
    _route(prob.solver, False)
    with OBS.tracing():
        prob.solver.fit(prob.body, prob.cam, mode=mode)
    assert not any(k.startswith("replays/")
                   for k in prob.solver.trace_counts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_marks_pair_per_section(case, untraced):
    prob, mode, _ = untraced[case, False]
    _, _, ev = _fit(prob, mode, False, True, True)
    marks = [MARK.match(n).groups() for n, _, _ in ev if MARK.match(n)]
    seen = {m[0] for m in marks}
    assert {"vposer", "blend", "fk", "skin", "contact", "losses",
            "adam"} <= seen <= set(OBS.SECTIONS)
    for sec in seen:
        fwd = [m[2] for m in marks if m[0] == sec and m[1] == "fwd"]
        assert fwd == ["begin", "end"] * (len(fwd) // 2), sec
    # runs of one section and direction, in the order of all marks
    runs = []
    for sec, way, edge in marks:
        if runs and runs[-1][0] == (sec, way):
            runs[-1][1].append(edge)
        else:
            runs.append(((sec, way), [edge]))
    for (sec, way), edges in runs:
        assert edges[0] == "begin" and edges[-1] == "end", (sec, way, edges)
    assert ("skin", "bwd") in {key for key, _ in runs}
    # a CPU solve skins on the plain route only
    counts = prob.solver.trace_counts
    assert counts.get("skin/plain", 0) > 0 and "skin/cuda" not in counts


def test_mark_returns_its_input():
    x = torch.ones(3, requires_grad=True)
    pair = (x, None)
    assert OBS.mark("blend", x) is x and OBS.mark("blend", pair) is pair
    with OBS.tracing(sections=True):
        assert OBS.mark("blend", x) is x
        assert OBS.mark("blend", x * 2, end=True) is not None
        with pytest.raises(ValueError, match="sections"):
            OBS.mark("nosuch", x)
    assert not (OBS.spans_on or OBS.sections_on)


def test_marker_source_names_the_sections():
    src = (cuda_build.CSRC / "mark.cu").read_text()
    listed = re.search(r"#define FPV4D_SECTIONS\(X\)(.*?)\n\n", src, re.S)
    assert tuple(re.findall(r"X\((\w+)\)", listed.group(1))) == OBS.SECTIONS
    edges = re.findall(r"fpv4d_mark_##s##_(\w+)\(\) \{\}", src)
    assert tuple(edges) == OBS.EDGES


def test_trace_writes_the_program_spans(tmp_path):
    prob, mode = _problem("global-brute")
    prob.solver.config = dataclasses.replace(prob.solver.config,
                                             num_iter=5)
    for sections in (False, True):
        with OBS.trace(str(tmp_path / str(sections)),
                       sections=sections) as path:
            prob.solver.fit(prob.body, prob.cam, mode=mode)
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        assert {"fpv4d.fit", "fpv4d.phase/global_a"} <= names
        assert any(MARK.match(n) for n in names) == sections


@pytest.mark.gpu
def test_traced_graph_route_on_the_card():
    """The graph route at T = 12 with spans and with marks: the same bits
    as tracing off, every section's markers in the device trace, and a
    replay per step past the warm-ups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the marker kernels)")
    for case in ("local-brute", "dct-grid"):
        prob, mode = _problem(case, "cuda")
        base = prob.solver.fit(prob.body, prob.cam, mode=mode)
        for sections in (False, True):
            with OBS.tracing(on=True, sections=sections):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, hist = prob.solver.fit(prob.body, prob.cam,
                                                  mode=mode)
                    torch.cuda.synchronize()
            for k in base[1]:
                assert np.array_equal(hist[k], base[1][k]), (case, k)
            for a, b in zip(state, base[0]):
                assert torch.equal(a, b)
            names = {e.name() for e in prof.profiler.kineto_results.events()}
            secs = {MARK.search(n).group(1) for n in names if MARK.search(n)}
            want = {"adam", "losses"} | ({"vposer", "blend", "fk", "skin",
                                          "contact"} if sections else set())
            assert (secs >= want) if sections else not secs, (case, secs)
