"""Without a card the benchmark exits non-zero and prints no result."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "local-grid",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
