"""On the card (skipped elsewhere): each tiny cell through the whole
harness, traced, comes out correct and its device trace names its
contact kernel (K1 on the grid's tables, K2 on the whole scene); and
each cell at its own size, with the replays of its captured steps left
without their Adam update, comes out not correct."""
from __future__ import annotations

import io

import pytest

from perfbench import run
from perfbench.tests import faults
from perfbench.tests.conftest import CELLS, tiny_cell

KERNEL_SHARE = {"local-grid": "k1_roofline", "global-brute": "k2_roofline",
                "dct-grid": "k1_roofline"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(cell, card):
    bench, wl, cfg = tiny_cell(cell)
    err = io.StringIO()
    res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 21, 0.5, True, card,
                           err=err)
    assert rc == 0 and res["correct"] is True, err.getvalue()
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert KERNEL_SHARE[cell] in res["metrics"]
    assert 0 < res["metrics"][KERNEL_SHARE[cell]]["value"] <= 105


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_replays_that_leave_the_state_are_not_correct(cell, card):
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    wl, cfg = run.load_cell(cell)
    err = io.StringIO()
    with faults.replays_leave_the_state():
        res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 33, 1.0, False,
                               card, err=err)
    assert rc == 0 and res is not None, err.getvalue()
    assert res["correct"] is False, err.getvalue()
