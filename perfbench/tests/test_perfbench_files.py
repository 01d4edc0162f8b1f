"""BENCHMARK.json against its contract's form, and every file it names:
each cell's workload (its traffic in it), each configuration and each
metric's reader exist and parse; every name, unit and key is of the allowed
characters."""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert len(c["source"]) <= 200
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        f = json.loads((ROOT / "perfbench/workloads" /
                        f"{w['name']}.json").read_text())
        assert {k: f[k] for k in ("name", "config", "traffic", "chips")} == \
            {k: w[k] for k in ("name", "config", "traffic", "chips")}
        assert f["limits"] and f["mode"] and f["clips"] > 0
        assert importlib.import_module(f"perfbench.drivers.{f['entry']}")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    seen = set()
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        base = m["name"].split(".")[0]
        mod = importlib.import_module(f"perfbench.metrics.{base}")
        assert callable(mod.read)
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        else:
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
            assert m["layer"] and "\n" not in m["layer"]
            assert set(m) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"
    if kind == "end_to_end":
        assert "setup_s" in seen


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        pl = [m for m in BENCH["per_layer"]
              if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and pl


def test_paths_hold_only_named_files():
    for f in (ROOT / "perfbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
