"""Shared pieces of the harness's CPU tests: each cell cut to a size the
CPU runs in seconds (V = 512, T = 12, a 1,024-point scene, a few steps a
phase), run through the harness's own driver and reference."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402

CELLS = ("local-grid", "global-brute", "dct-grid")


def tiny_cell(cell: str):
    """(BENCHMARK.json, the cell's workload, its configuration cut to
    the tiny size)."""
    bench = run.load_json(ROOT / "BENCHMARK.json")
    wl, cfg = run.load_cell(cell)
    wl.update(clips=64)
    cfg.update(num_verts=512, frames=12, scene_points=1024, num_iter=10,
               num_iter_dct=60, window=12, skate_subset=64, compact=32,
               cell_budget=8)
    return bench, wl, cfg


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
