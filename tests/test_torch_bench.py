"""The port's bench entry point (fpv4d_torch/bench.py) and its cost
count (fpv4d_torch/utils/cost.py), on the CPU:

* a whole small run in a subprocess (--device cpu): one JSON line last,
  under 2,000 characters, with the metric, every compact key and
  `correct`, every share of a device time null, nothing written in the
  repository; the accuracy block takes its small sizes there (12
  frames, 30 keypoint iterations, no deep or frontier rows);
* bench_mode's local schedule and final losses against the root
  bench.py's bench_mode on the same seeded problem (the JAX solver on
  the grid with its XLA candidate search, as the port's runs); the
  tolerances are tests/test_torch_clip_solve.py's for those phases. As
  there, the betas get a small per-frame variation, the same array on
  both sides: the standard clip's betas are exactly constant, so after
  the first Adam step their second differences are rounding noise whose
  sign the L1 smoothness term follows, and XLA's and PyTorch's last bits
  then steer the two trajectories apart (0.5% on local_a's last loss
  without it, 4e-6 with it);
* step_cost counts the same work whatever implements it (the FK's
  hand-written adjoint or autograd, a contact search that the counter
  would see), twice over; its matmul count of the VPoser decode equals
  one written out from the layer widths; its bytes follow the rule of
  each tensor read once and written once;
* no card without --device cpu, or a failing block: exit 1 and no
  result line.
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpv4d_torch import bench as tbench
from fpv4d_torch.models import fk
from fpv4d_torch.models import vposer as VP
from fpv4d_torch.ops import cand_cuda
from fpv4d_torch.utils import cost
from fpv4d_torch.utils.bench_problem import standard_problem

from helpers import smooth_noise

ROOT = Path(__file__).resolve().parents[1]

_COMPACT = ("device", "power_limit", "modes_steady_s", "solve_mfu",
            "launches_per_solve", "phase_ms_per_step", "k1_ms", "k2_ms",
            "keypoint_fit_fps", "keypoint_step_graphs",
            "keypoint_capture_s", "keypoint_fleet_fps",
            "keypoint_optimizer_fps", "fleet_clips_per_hour_per_chip",
            "fleet_per_clip_vs_single", "fleet_modes_clips_per_hour",
            "fleet_max_clips_per_chip", "fleet_implied_gb_per_clip",
            "fleet_gib_per_clip", "accuracy", "pallas_ok", "cand_kernel_ok",
            "full_results")
_DEVICE_SHARES = ("tflops_achieved", "mfu", "gbps", "bytes_frac",
                  "busy_frac")
_TPU_RECORDS = ("bench_out.json", "bench_out_cpu.json")


def _small_env(tmp_path, **kw):
    env = dict(os.environ, FPV4D_BENCH_SMALL="1", FPV4D_BENCH_FRAMES="8",
               FPV4D_BENCH_MODES="local", FPV4D_BENCH_MULTI="2",
               FPV4D_BENCH_OUT=str(tmp_path / "bench_full.json"))
    env.update(kw)
    return env


def _digest(path: Path):
    return hashlib.sha1(path.read_bytes()).hexdigest() if path.exists() \
        else None


def test_small_cpu_run_prints_one_compact_line(tmp_path):
    before = sorted(p.name for p in ROOT.iterdir())
    records = {n: _digest(ROOT / n) for n in _TPU_RECORDS}
    r = subprocess.run(
        [sys.executable, "-m", "fpv4d_torch.bench", "--device", "cpu"],
        cwd=ROOT, env=_small_env(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.strip().splitlines()[-1]
    assert len(line) < 2000
    out = json.loads(line)
    assert out["metric"] == "clip_joint_opt_8f_local_mode_wallclock"
    assert out["unit"] == "s" and out["correct"] is True
    assert out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(60.0 / out["value"],
                                               rel=1e-2)
    ex = out["extras"]
    assert set(_COMPACT) <= set(ex), set(_COMPACT) - set(ex)
    assert ex["device"] == "cpu" and ex["power_limit"] is None
    assert ex["solve_mfu"] == {"local": None}
    assert ex["k1_ms"] is None and ex["k2_ms"] is None
    assert ex["pallas_ok"] is None and ex["cand_kernel_ok"] is None
    # counts are printed off the card: the plain versions launch nothing
    assert ex["launches_per_solve"] == {"local": [0, 0]}
    # the CPU runs every keypoint stage eagerly: no capture
    assert ex["keypoint_step_graphs"] is False
    assert ex["keypoint_capture_s"] == {"fit": 0, "fleet": 0, "lbfgs": 0,
                                        "lbfgs_perframe": 0}
    assert ex["fleet_max_clips_per_chip"] is None
    assert ex["fleet_implied_gb_per_clip"] is None
    full = json.loads((tmp_path / "bench_full.json").read_text())
    assert full["metric"] == out["metric"] and full["correct"] is True
    phases = full["extras"]["phases"]
    assert {k: v["steps"] for k, v in phases.items()} == {
        "local_a": 16, "local_b": 4, "skate": 8}
    assert phases["local_a"]["gflops_per_step"] > 0
    assert phases["local_a"]["lazy"]["gflops_per_step"] > 0
    for v in phases.values():
        assert all(v[k] is None for k in _DEVICE_SHARES)
        assert all(v.get("lazy", {}).get(k) is None
                   for k in _DEVICE_SHARES[:4])
    for check in ("pallas_check", "cand_kernel_check"):
        for case in full["extras"][check]["cases"].values():
            assert case["ms"] is None and case["share"] is None
            assert case["bound_ms"] > 0
    mc = full["extras"]["multi_clip"]
    assert mc["clips"] == 2 and mc["peak_gib"] is None
    assert mc["grid_cache"] == {"hits": 3, "misses": 1}
    # nothing written in the repository, the TPU records untouched
    assert sorted(p.name for p in ROOT.iterdir()) == before
    assert {n: _digest(ROOT / n) for n in _TPU_RECORDS} == records


def _load_root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_PROBLEM = dict(T=6, num_verts=256, scene_pts=256, num_iter=10,
                num_iter_dct=20, skate_subset=0)


def test_local_schedule_and_losses_match_the_root_bench(tmp_path):
    from fpv4d.utils import bench_problem as JBP
    jp = JBP.standard_problem(**_PROBLEM, cache_dir=str(tmp_path / "j"))
    js = dataclasses.replace(
        jp.solver, nn_impl="grid",
        config=dataclasses.replace(jp.solver.config, cand_impl="xla"))
    tp = standard_problem(**_PROBLEM, device="cpu",
                          cache_dir=str(tmp_path / "t"))
    np.testing.assert_array_equal(tp.body, jp.body)
    body = jp.body.copy()
    body[:, 6:16] += smooth_noise(len(body), 10, np.random.RandomState(7),
                                  0.05)
    j_phases = {}
    _load_root_bench().bench_mode(js, jnp.asarray(body),
                                  jnp.asarray(jp.cam), "local", "cpu",
                                  j_phases)
    t_phases = {}
    tbench.bench_mode(tp.solver, body, tp.cam, "local", t_phases)
    assert list(t_phases) == list(j_phases) == ["local_a", "local_b",
                                                "skate"]
    assert {k: v["steps"] for k, v in t_phases.items()} == {
        "local_a": 8, "local_b": 2, "skate": 4}
    assert {k: v["steps"] for k, v in j_phases.items()} == {
        k: v["steps"] for k, v in t_phases.items()}
    assert ("ms_per_step_lazy" in t_phases["local_a"]
            and "ms_per_step_lazy" in j_phases["local_a"])
    for k, rtol in (("local_a", 1e-4), ("local_b", 1e-4), ("skate", 1e-3)):
        np.testing.assert_allclose(t_phases[k]["final_loss"],
                                   j_phases[k]["final_loss"], rtol=rtol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def small():
    """A small standard problem on the CPU, its state and tables."""
    prob = standard_problem(T=6, num_verts=256, scene_pts=400, num_iter=10,
                            num_iter_dct=20, skate_subset=64, device="cpu")
    s = prob.solver
    st, target, weights = s.init_state(prob.body, prob.cam)
    state, _ = s.make_optimizer(st)
    return dict(solver=s, state=state, target=target, weights=weights,
                cands=s._refresh_cands(state),
                weight_right=s.detect_contact(state))


def _count(sm, phase, lazy):
    return cost.step_cost(
        sm["solver"], phase, sm["state"], sm["target"], sm["weights"],
        cands=sm["cands"] if lazy else None,
        weight_right=sm["weight_right"] if phase == "skate" else None)


_PHASES = [("local_a", True), ("local_a", False), ("local_b", False),
           ("global_a", True), ("global_b", False), ("dct_a", False),
           ("dct_b", True), ("skate", False)]


@pytest.mark.parametrize("phase,lazy", _PHASES)
def test_step_cost_does_not_depend_on_the_fk_route(small, phase, lazy,
                                                   monkeypatch):
    monkeypatch.setattr(fk, "rigid_transform_prod", fk.rigid_transform)
    adjoint = _count(small, phase, lazy)
    assert fk.rigid_transform_prod is fk.rigid_transform      # restored
    monkeypatch.setattr(fk, "rigid_transform_prod", fk.rigid_transform_ref)
    autograd = _count(small, phase, lazy)
    assert adjoint == autograd == _count(small, phase, lazy)
    flops, nbytes = autograd
    assert nbytes > 0
    # local_b (reconstruction and smoothness) multiplies no matrices
    assert (flops > 0) == (phase != "local_b")


def test_step_cost_counts_the_contact_search_from_shapes(small,
                                                         monkeypatch):
    """The search's pairs at 8 FLOPs each, whichever route computes it:
    a search the counter would see (a Gram-form matmul) changes
    nothing."""
    s = small["solver"]
    lazy = _count(small, "local_a", True)
    exact = _count(small, "local_a", False)
    T, N = small["target"].shape[0], len(s.contact_vids)
    P, Kg = small["cands"].cand.shape[1], s.grid.cand_pts.shape[1]
    assert lazy[0] - exact[0] == 8 * T * N * (P - Kg)

    def gram(q_, cand, valid):
        d = ((q_ ** 2).sum(-1, keepdim=True) - 2 * q_ @ cand.transpose(1, 2)
             + (cand ** 2).sum(-1)[:, None])
        d = torch.where(valid[:, None], d, cand_cuda.BIG)
        dist, slot = d.min(-1)
        near = torch.gather(cand, 1, slot[..., None].expand(-1, -1, 3))
        return dist, slot.int(), near

    monkeypatch.setattr(cand_cuda, "cand_nn", gram)
    assert _count(small, "local_a", True) == lazy


def test_vposer_matmul_flops_by_hand():
    vp = VP.random_params(seed=0)
    B = 7
    lat = torch.randn(B, VP.LATENT_DIM, requires_grad=True)
    widths = [(VP.LATENT_DIM, VP.HIDDEN_DIM), (VP.HIDDEN_DIM, VP.HIDDEN_DIM),
              (VP.HIDDEN_DIM, VP.NUM_JOINTS * 6)]
    # forward x @ w and backward g @ w.T (the weights take no gradient),
    # 2 FLOPs per multiply-add
    want = sum(2 * 2 * B * i * o for i, o in widths)
    got = cost.matmul_flops(
        lambda: VP.decode(vp, lat, output_type="matrot").sum(), [lat])
    assert got == want


def test_step_cost_bytes_read_once_and_written_once(small):
    """local_b reads the body leaf, the target and the frame weights:
    its bytes are the four leaves' Adam traffic (each leaf read and
    written, its gradient written, both moments read and written) and
    those two tensors read once."""
    leaves = sum(x.nbytes for x in small["state"])
    _, nbytes = _count(small, "local_b", False)
    assert nbytes == 7 * leaves + small["target"].nbytes \
        + small["weights"].nbytes


@pytest.mark.parametrize("spans,want", [
    ([], (0.0, 0.0)),
    ([(1.0, 3.0), (0.0, 2.0), (5.0, 6.0)], (4.0, 6.0)),
    ([(5.0, 6.0), (0.0, 10.0), (2.0, 4.0)], (10.0, 10.0))])
def test_busy_time_counts_overlapping_work_once(spans, want):
    """The busy share's numerator is the union of the device's kernel
    and copy intervals, so it never exceeds their span, nor the window
    the profile takes (which is at least that span)."""
    from fpv4d_torch.utils.profile_local import busy_span
    busy, span = busy_span(spans)
    assert (busy, span) == want
    assert busy <= span


def test_no_card_without_device_cpu_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "no CUDA device" in cap.err


@pytest.mark.parametrize("block", ["setup", "headline"])
def test_a_failing_block_fails_the_run(block, monkeypatch, capsys,
                                       tmp_path):
    for k, v in _small_env(tmp_path).items():
        if k.startswith("FPV4D_BENCH_"):
            monkeypatch.setenv(k, v)

    def boom(self):
        raise RuntimeError(f"{block} broke")

    monkeypatch.setattr(tbench.Bench, block, boom)
    assert tbench.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert f"FAILED in block {block!r}" in cap.err
    assert not (tmp_path / "bench_full.json").exists()
