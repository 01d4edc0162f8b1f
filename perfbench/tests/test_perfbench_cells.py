"""Each cell at a tiny size on the CPU, through the harness's driver and
reference (the port's plain kernels stand in for K1 and K2 there): the
run is correct, reports the cell's metrics by the contract's shape, and
its result closes with the compared numbers beside their limits."""
from __future__ import annotations

import io
import json

import pytest

from perfbench import run
from perfbench.tests.conftest import CELLS, tiny_cell


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_correct(cell, traced):
    bench, wl, cfg = tiny_cell(cell)
    err = io.StringIO()
    res, rc = run.run_cell(bench, wl, cfg, 2 ** 31 + 77, 0.2, traced, "cpu",
                           err=err)
    assert rc == 0 and res is not None, err.getvalue()
    assert res["correct"] is True, err.getvalue()
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for k, lim in wl["limits"].items():
        assert res["checks"][k]["limit"] == lim
        assert 0 <= res["checks"][k]["value"] <= lim
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in run.cell_metrics(bench, cell, kind)}
    got = set(res["metrics"])
    # on the CPU nothing has device time: kernel shares are left out
    assert got <= want
    assert {"clip_s", "setup_s"} <= got or traced
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(run.finite(res), allow_nan=False)
    last = err.getvalue().strip().splitlines()[-len(wl["limits"]):]
    assert all(line.startswith("check ") for line in last)


def test_same_seed_same_inputs():
    import torch
    from perfbench.inputs import synth
    _, wl, cfg = tiny_cell("local-grid")
    a = synth.session(2 ** 33 + 5, cfg, 3, "cpu")
    b = synth.session(2 ** 33 + 5, cfg, 3, "cpu")
    c = synth.session(2 ** 33 + 6, cfg, 3, "cpu")
    for x, y in ((a.bodies, b.bodies), (a.scene, b.scene),
                 (a.model["posedirs"], b.model["posedirs"])):
        assert torch.equal(x, y)
    assert not torch.equal(a.bodies, c.bodies)
    # every seed the same sizes
    assert a.vids_left.shape == c.vids_left.shape
    assert a.scene.shape == c.scene.shape
