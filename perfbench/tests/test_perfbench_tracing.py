"""The readers of the port's own trace on hand-built records of raw
events (``perfbench/metrics/_spans.py``'s tuples), each None without its
data; ``--trace 0`` never turns the port's tracing on; and the tiny
``local-brute`` cell through the harness, as ``test_perfbench_cells.py``
runs the others (its traced run adds the span and section solves)."""
from __future__ import annotations

import pytest

from perfbench import run
from perfbench.tests import test_perfbench_cells as cells
from perfbench.tests.conftest import tiny_cell


def D(name, s, e, corr=0):
    return (name, "device", s, e, corr)


def H(name, s, e, corr=0):
    return (name, "host", s, e, corr)


def M(section, way, edge, s):
    return D(f"fpv4d_mark_{section}_{way}_{edge}", s, s + 1)


# the section solve: vposer forward (two overlapping kernels, 6 ns), skin
# forward, blend backward with its edges interleaved (8 + 2 ns), vposer
# backward (1 ns), two refreshes (10 and 4 ns) apart
SECTION_SOLVE = {"events": [
    M("vposer", "fwd", "begin", 0), D("k", 2, 5), D("k", 4, 8),
    M("vposer", "fwd", "end", 9),
    M("skin", "fwd", "begin", 10), D("k", 12, 14), M("skin", "fwd", "end", 15),
    M("blend", "bwd", "begin", 20), D("k", 22, 30),
    M("blend", "bwd", "end", 31), D("k", 33, 35),
    M("blend", "bwd", "begin", 36), M("blend", "bwd", "end", 40),
    M("vposer", "bwd", "begin", 50), D("k", 52, 53),
    M("vposer", "bwd", "end", 54),
    M("refresh", "fwd", "begin", 60), D("k", 62, 72),
    M("refresh", "fwd", "end", 73),
    M("skin", "fwd", "begin", 75), M("skin", "fwd", "end", 76),
    M("refresh", "fwd", "begin", 80), D("k", 82, 86),
    M("refresh", "fwd", "end", 87)], "counts": {}}

# the span solve: device busy 20-60, 110-150, 260-290, 360-700, 820-840,
# 950-990 inside fit 0-1000; two replays of local_a, whose graph
# launches at 400 and 500 hold 3 kernels each (and a copy); the launch at
# 320 is a refresh's, the one at 850 is outside the phase
SPAN_SOLVE = {"events": [
    H("fpv4d.fit", 0, 1000), H("fpv4d.phase/init", 0, 100),
    H("fpv4d.phase/local_a", 100, 800), H("fpv4d.warmup/local_a", 100, 120),
    H("fpv4d.capture/local_a", 150, 250),
    H("fpv4d.refresh/local_a", 300, 350), H("fpv4d.checkpoint", 800, 900),
    H("fpv4d.phase/local_b", 900, 1000),
    D("k", 20, 60), D("k", 110, 150), D("k", 260, 290), D("k", 360, 700),
    D("k", 820, 840), D("k", 950, 990),
    H("cudaGraphLaunch", 400, 401, 7), H("cudaGraphLaunch", 500, 501, 8),
    H("cudaGraphLaunch", 320, 321, 9), H("cudaGraphLaunch", 850, 851, 10),
    D("a", 400, 410, 7), D("b", 410, 420, 7), D("c", 420, 430, 7),
    D("Memcpy DtoD (Device -> Device)", 430, 431, 7),
    D("a", 500, 510, 8), D("b", 510, 520, 8), D("c", 520, 530, 8),
    D("a", 270, 271, 9), D("a", 830, 831, 10)],
    "counts": {"replays/local_a": 2, "device_allocs": 12}}

RECORD = {"span_solve": SPAN_SOLVE, "section_solve": SECTION_SOLVE}

EXPECTED = {
    "section_s.vposer": 7e-9,
    "section_s.blend": 10e-9,
    "section_s.skin": 2e-9,
    "refresh_ms": 7e-6,
    "idle_s.init": 70e-9,
    "idle_s.capture": 110e-9,
    "idle_s.checkpoint": 110e-9,
    # local_a less its warm-up, capture and refresh: 530 ns, busy 400
    "replay_gap_us.local_a": 65e-3,
    "kernels_per_step.local_a": 3.0,
    "device_allocs": 12.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_raw_events(name):
    assert run.read_metric(name, RECORD) == pytest.approx(EXPECTED[name],
                                                          rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED) + [
    "section_s.adam", "replay_gap_us.dct_a", "kernels_per_step.dct_a"])
def test_reader_without_its_data(name):
    assert run.read_metric(name, {}) is None
    bare = {k: {"events": [H("fpv4d.fit", 0, 9)], "counts": {}}
            for k in RECORD}
    assert run.read_metric(name, bare) is None


def _records(monkeypatch):
    """The records run_cell hands the readers."""
    seen = []
    orig = run.read_metric

    def read(name, record):
        seen.append(record)
        return orig(name, record)

    monkeypatch.setattr(run, "read_metric", read)
    return seen


def test_untraced_run_never_traces(monkeypatch):
    from fpv4d_torch.utils import observability
    entered = []
    orig = observability.tracing
    monkeypatch.setattr(observability, "tracing",
                        lambda *a, **k: entered.append(1) or orig(*a, **k))
    seen = _records(monkeypatch)
    bench, wl, cfg = tiny_cell("local-brute")
    res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 77, 0.2, False, "cpu")
    assert rc == 0 and res["correct"] is True
    assert seen and not entered
    assert not {"span_solve", "section_solve"} & set(seen[0])


def test_traced_run_adds_the_two_solves(monkeypatch):
    seen = _records(monkeypatch)
    bench, wl, cfg = tiny_cell("local-brute")
    res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 78, 0.2, True, "cpu")
    assert rc == 0 and res["correct"] is True
    rec = seen[0]
    for key in ("span_solve", "section_solve"):
        names = {e[0] for e in rec[key]["events"]}
        assert {"fpv4d.fit", "fpv4d.phase/local_a",
                "fpv4d.checkpoint"} <= names
    sec = {e[0] for e in rec["section_solve"]["events"]}
    assert any(n.startswith("fpv4d_mark_contact_") for n in sec)
    assert not any(n.startswith("fpv4d_mark_")
                   for n, *_ in rec["span_solve"]["events"])


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_local_brute_runs_correct(traced):
    cells.test_tiny_cell_runs_correct("local-brute", traced)
