"""The port's ground-truth recovery report (fpv4d_torch.utils.
accuracy_report) against the reference's (tools/accuracy_report.py), on
the same seeded truth, observations and noisy initialization.

Tolerances: the truth's and the noisy init's jitter and MPJPE come from
the same draws through two packages' models: within 1e-2 mm. The solved
values go through 3 x 30 Adam steps of the keypoint fit and a 30-step
clip solve, which amplify rounding (ROADMAP.md section 3), and the
reference solves its contact term by brute force on the CPU where the
port takes its voxel grid (the scene is 10 m below the body, so the
term is saturated in both): rtol 5e-2. tests/test_accuracy.py's
thresholds hold on the port's report."""
import json
import os
import sys

import pytest

from fpv4d_torch.utils import accuracy_report

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

KW = dict(frames=12, num_verts=256, iters=30, clip_iters=30)


@pytest.fixture(scope="module")
def reports():
    import accuracy_report as reference
    return (accuracy_report.run(**KW, device="cpu"), reference.run(**KW))


def test_same_truth_and_noise(reports):
    got, want = reports
    assert sorted(got) == sorted(want)
    for k in ("jitter_mm_truth", "jitter_mm_noisy",
              "clip_solve_mpjpe_mm_before"):
        assert got[k] == pytest.approx(want[k], abs=1e-2), k
    for k in ("frames", "keypoint_optimizer", "obs_noise_px", "clip_iters",
              "rec_weight"):
        assert got[k] == want[k], k


def test_solved_values_near_the_reference(reports):
    got, want = reports
    for k in ("keypoint_fit_mpjpe_mm", "keypoint_fit_reproj_px",
              "jitter_mm_solved", "clip_solve_mpjpe_mm_after"):
        assert got[k] == pytest.approx(want[k], rel=5e-2), k
    assert got["keypoint_fit"]["adam"]["mpjpe_mm"] == pytest.approx(
        want["keypoint_fit"]["adam"]["mpjpe_mm"], rel=5e-2)


def test_recovery_thresholds(reports):
    """tests/test_accuracy.py's thresholds on the port's report."""
    r = reports[0]
    assert r["keypoint_fit_mpjpe_mm"] < 60
    assert r["keypoint_fit_reproj_px"] < 4 * r["obs_noise_px"]
    assert r["clip_solve_mpjpe_mm_after"] < r["clip_solve_mpjpe_mm_before"]
    assert r["jitter_mm_solved"] < 0.3 * r["jitter_mm_noisy"]


def test_cli_both_optimizers(capsys):
    rc = accuracy_report.main(["--device", "cpu", "--frames", "12",
                               "--num-verts", "256", "--iters", "10",
                               "--optimizer", "both"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out["keypoint_fit"]) == ["adam", "lbfgs"]
    assert out["keypoint_optimizer"] == "adam"
    assert out["clip_iters"] == 60 and out["frames"] == 12


def test_cli_without_a_card_exits_1(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert accuracy_report.main(["--frames", "6"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
