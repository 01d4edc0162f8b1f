"""The check fails what it must, at a tiny size on the CPU:

* the control, the reference in TF32 put in the program's place (each
  product's operands rounded to 10 mantissa bits), fails at least one of
  each cell's numbers (on the card, at the cells' own sizes, it is read
  by ``python3 -m perfbench.tests.readings``);
* a whole run with the timed path broken underneath comes out not
  correct, once for each fault a one-card solve can have: an Adam step
  that returns the state unchanged; one that does so only in the
  replays of a captured step (on the graph route, here with a stand-in
  capture that reruns the step; ``test_perfbench_card.py`` plants it in
  the card's graphs at each cell's own size); the contact term's mean
  taken over half of the clip's frames; the losses altered where they
  are produced. (No cell runs on more than one card, so there is no
  exchange between chips to leave out.)
"""
from __future__ import annotations

import contextlib
import io
import tempfile

import pytest
import torch

from perfbench import run
from perfbench.drivers import clip_solve as D
from perfbench.tests import faults
from perfbench.tests.conftest import CELLS, tiny_cell


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2 ** 32 + 12, 13])
def test_control_fails_a_number(cell, seed):
    _, wl, cfg = tiny_cell(cell)
    d = D.make(cfg, wl, seed, "cpu", tempfile.mkdtemp())
    try:
        d.solve(0)
        d.solve(1)
        p = d.problem()
        prog = d.check(p, 2)
        ctl = d.check(p, 2, "tf32", "f32")
    finally:
        d.close()
    lim = wl["limits"]
    assert all(g[k] <= v for g in prog.values() for k, v in lim.items())
    assert all(any(g[k] > v for k, v in lim.items()) for g in ctl.values())


def _noop_step(self):
    return None


def _half_frames_contact(dist_sq):
    r = torch.sqrt(dist_sq[: dist_sq.shape[0] // 2] + 1e-4)
    return torch.mean(r / (r + 1.0))


def _altered(orig):
    def run_phase(self, *a, **k):
        return orig(self, *a, **k) * (1 + 1e-4)
    return run_phase


def _faults():
    from fpv4d_torch.ops import losses
    from fpv4d_torch.solve.adam import Adam
    from fpv4d_torch.solve.clip_solve import ClipSolver
    return {
        "state_unchanged": (Adam, "step", _noop_step),
        "half_the_frames": (losses, "robust_contact", _half_frames_contact),
        "losses_altered": (ClipSolver, "_run_phase_auto",
                           _altered(ClipSolver._run_phase_auto)),
    }


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "replays_unchanged",
                                   "half_the_frames", "losses_altered"])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    planted = contextlib.ExitStack()
    if fault == "replays_unchanged":
        planted.enter_context(faults.graph_route_off_the_card())
        planted.enter_context(faults.replays_leave_the_state())
    else:
        owner, name, fn = _faults()[fault]
        monkeypatch.setattr(owner, name, fn)
    bench, wl, cfg = tiny_cell(cell)
    err = io.StringIO()
    with planted:
        res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 5, 0.2, False,
                               "cpu", err=err)
    assert rc == 0 and res is not None, err.getvalue()
    assert res["correct"] is False, err.getvalue()
    assert res["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_stand_in_graph_route_is_correct(cell):
    """The replay fault's route without the fault: correct, so what the
    fault's run fails on is the fault."""
    bench, wl, cfg = tiny_cell(cell)
    err = io.StringIO()
    with faults.graph_route_off_the_card():
        res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 5, 0.2, False,
                               "cpu", err=err)
    assert rc == 0 and res["correct"] is True, err.getvalue()
