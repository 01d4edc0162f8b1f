"""The compiled L-BFGS keypoint stages and the compiled contact refresh.

* solve/lbfgs.py's device form on its phase program: every iteration's
  pieces (start, reeval, begin, round, finish) captured once per key,
  the line search's end read through ``PhaseProgram.gate``. With a
  stand-in capture whose replay reruns the piece, the gate runs every
  round up to the search's cap, so a round run after every lane has
  ended must change nothing: bit-equal to the eager route on the
  float64 problems of tests/test_torch_lbfgs.py and through the three
  stages of ``fit_keypoints`` (joint and per frame, 1 and 2 clips);
* the sync guard of tests/test_torch_frame_graphs.py around each
  captured piece of both line searches, and around the single solver's
  and the one-rank fleet's captured refresh, SDF linearization and
  planted-foot detection;
* the refresh's device constants against the ``torch.tensor`` uploads
  they replace, bit for bit;
* the routes: ``step_graphs=True`` on the CPU raises for the L-BFGS
  optimizers.

Small sizes: T <= 12, V = 256, C <= 2. The module imports no JAX.
"""
import numpy as np
import pytest
import torch

from test_torch_frame_graphs import (  # noqa: F401 (fixtures)
    GuardedCapture, RerunCapture, graph_route, kp_setup)
from test_torch_step_graph import _programmed, _small
from fpv4d_torch.config import KeypointFitConfig
from fpv4d_torch.ops import nn as NN
from fpv4d_torch.ops import sdf as SDF
from fpv4d_torch.parallel.multi_clip import MultiClipSolver
from fpv4d_torch.solve import keypoint_fit, lbfgs, step_graph
from fpv4d_torch.utils.bench_problem import fleet_batch

_PIECES = {"start", "reeval", "begin", "round", "finish"}


def _rosenbrock(x):
    return torch.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                     + (1.0 - x[..., :-1]) ** 2, dim=-1)


def _quadratic(x):
    d = torch.as_tensor(np.logspace(0, 3, x.shape[-1]))
    return 0.5 * torch.sum(d * (x - 1.0) ** 2, dim=-1)


_PROBLEMS = {
    "rosenbrock": (_rosenbrock, [[-1.2, 1.0, -0.5, 0.8, 1.5, -1.0],
                                 [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                                 [2.0, -1.5, 1.0, 0.3, -0.7, 1.2]]),
    "ill_conditioned_quadratic": (_quadratic, [
        [3.0, -2.0, 0.5, 1.5, -1.0, 2.5, 0.1, -0.3],
        [-1.0, 4.0, 2.0, -3.0, 0.0, 1.0, 2.0, 0.5]]),
}


@pytest.mark.parametrize("problem", sorted(_PROBLEMS))
@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
def test_minimize_graph_route_matches_eager(problem, linesearch):
    """20 iterations in float64: the stand-in graph route, every round up
    to the cap each iteration, gives the eager route's iterates and
    values bit for bit, each piece captured once."""
    fn, x0 = _PROBLEMS[problem]
    x0 = torch.tensor(x0, dtype=torch.float64)
    r_e, r_g = [], []
    x_e, h_e = lbfgs.minimize(fn, x0, 20, linesearch=linesearch,
                              rounds=r_e)
    prog = step_graph.PhaseProgram("cpu", True, RerunCapture)
    x_g, h_g = lbfgs.minimize(fn, x0, 20, linesearch=linesearch,
                              program=prog, key=("k",), rounds=r_g)
    cap = (lbfgs.ZOOM_MAX_STEPS if linesearch == "zoom"
           else lbfgs.BACKTRACK_MAX_STEPS + 1)
    assert r_g == [cap] * 20
    assert 1 <= min(r_e) and max(r_e) <= cap and sum(r_e) < 20 * cap
    assert {k[1] for k in prog.capture_seconds} == _PIECES
    assert torch.equal(x_g, x_e) and torch.equal(h_g, h_e)


def test_memory_count_is_a_device_counter():
    """The direction's step count is an int32 tensor that each direction
    advances; the ring is written at (k - 1) mod m."""
    x = torch.arange(12, dtype=torch.float64).reshape(2, 6)
    mem = lbfgs._Memory(x, 3)
    for k in range(5):
        g = torch.full_like(x, float(k + 1))
        mem.direction(x + k, g)
    assert mem.count.dtype == torch.int32 and int(mem.count) == 5
    # k = 4 wrote slot 0 with the difference of iterates 3 and 4
    assert torch.equal(mem.dw[0], torch.ones_like(x))
    assert torch.equal(mem.du[0], torch.ones_like(x))


def _lbfgs_fit(s, case, optimizer, iters=3, **kw):
    kp, extra = (s["kp"], {}) if case == "plain" else (
        np.stack([s["kp"], s["kp"] + np.float32(2.0)]), {})
    return keypoint_fit.fit_keypoints(
        s["model"], s["vp"], kp,
        KeypointFitConfig(num_iter=iters, optimizer=optimizer),
        device="cpu", **extra, **kw)


@pytest.mark.parametrize("optimizer", ["lbfgs", "lbfgs_perframe"])
def test_lbfgs_iteration_never_syncs(kp_setup, graph_route, optimizer,
                                     monkeypatch):
    """Each piece of an iteration captured under the sync guard (the
    model builds no table there), three stages: the stand-in gate reads
    nothing, so a capture on the card reads nothing either."""
    made = graph_route(GuardedCapture)
    monkeypatch.setattr(GuardedCapture, "captured", [])
    monkeypatch.setattr(GuardedCapture, "models", [kp_setup["model"]])
    params, hist = _lbfgs_fit(kp_setup, "plain", optimizer)
    ls = "zoom" if optimizer == "lbfgs" else "backtracking"
    keys = set(made[0].capture_seconds)
    assert keys == {(st, ls, p) for st in ("camera", "body", "all")
                    for p in _PIECES}
    assert len(GuardedCapture.captured) == len(keys)
    assert set(keypoint_fit.capture_seconds) == {"camera", "body", "all"}
    assert np.all(np.isfinite(params))


@pytest.mark.parametrize("case", ["plain", "batched"])
@pytest.mark.parametrize("optimizer", ["lbfgs", "lbfgs_perframe"])
def test_keypoint_lbfgs_graph_plumbing_matches_eager(kp_setup, graph_route,
                                                     optimizer, case):
    """The three stages on the stand-in graph route (warm-up, a capture
    per piece, replays, every round to the cap): the eager route's
    parameters and histories bit for bit."""
    p_e, h_e = _lbfgs_fit(kp_setup, case, optimizer)
    rounds_e = {k: list(v) for k, v in keypoint_fit.lbfgs_rounds.items()}
    graph_route(RerunCapture)
    p_g, h_g = _lbfgs_fit(kp_setup, case, optimizer)
    assert set(keypoint_fit.capture_seconds) == {"camera", "body", "all"}
    assert set(rounds_e) == set(keypoint_fit.lbfgs_rounds)
    assert np.array_equal(p_g, p_e)
    assert h_g.keys() == h_e.keys()
    for k in h_e:
        assert np.array_equal(h_g[k], h_e[k]), k


def test_lbfgs_step_graphs_true_on_the_cpu_raises(kp_setup):
    for optimizer in ("lbfgs", "lbfgs_perframe"):
        with pytest.raises(ValueError, match="step_graphs"):
            _lbfgs_fit(kp_setup, "plain", optimizer, step_graphs=True)


# -- the contact refresh ------------------------------------------------------------

def test_single_refresh_never_syncs(monkeypatch):
    """local with lazy tables and a scene SDF: the refresh, the SDF
    linearization, the detection and every phase's step captured under
    the sync guard."""
    prob = _small(contact_refresh_steps=4)
    prob.solver.sdf = SDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
    made = _programmed(prob.solver, GuardedCapture)
    monkeypatch.setattr(GuardedCapture, "captured", [])
    _, hist = prob.solver.fit(prob.body, prob.cam, mode="local")
    keys = set(made[0].capture_seconds)
    assert {("local_a", True, True, "cands"), ("local_a", True, True, "sdf"),
            ("detect_contact",)} <= keys
    assert len(GuardedCapture.captured) == len(keys)
    assert all(np.all(np.isfinite(v)) for v in hist.values())


@pytest.mark.parametrize("compact", [32, 0])
def test_fleet_refresh_never_syncs(compact, monkeypatch):
    """The one-rank fleet's folded refresh (compacted a clip at a time,
    and uncompacted), SDF linearization and detection under the guard."""
    prob = _small(contact_refresh_steps=4, contact_compact=compact)
    prob.solver.sdf = SDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
    made = _programmed(prob.solver, GuardedCapture)
    monkeypatch.setattr(GuardedCapture, "captured", [])
    bodies, cams, scenes = fleet_batch(prob, 2)
    timings = {}
    _, hist = MultiClipSolver(solver=prob.solver).fit(
        bodies, cams, scenes, mode="local", timings=timings)
    keys = set(made[0].capture_seconds)
    assert {("local_a", True, True, "cands"), ("local_a", True, True, "sdf"),
            ("detect",)} <= keys
    assert len(GuardedCapture.captured) == len(keys)
    assert {"refresh", "sdf_refresh", "detect"} <= set(timings)
    assert all(np.all(np.isfinite(v)) for v in hist.values())


def test_fleet_refresh_writes_into_given_buffers():
    """refresh_cands and refresh_sdf into `out` equal their fresh
    results, and return `out`'s own tensors."""
    from fpv4d_torch.parallel import sharding as SH
    prob = _small(contact_compact=32)
    prob.solver.sdf = SDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
    mc = MultiClipSolver(solver=prob.solver)
    bodies, cams, scenes = fleet_batch(prob, 2)
    state_b, _, _ = mc.init_batch(bodies, cams)
    grid_b = mc._get_grids(scenes)
    fresh = SH.refresh_cands(prob.solver, state_b, grid_b)
    out = NN.FrameCands(torch.zeros_like(fresh.cand),
                        torch.zeros_like(fresh.valid))
    got = SH.refresh_cands(prob.solver, state_b, grid_b, out)
    assert got.cand is out.cand and torch.equal(got.cand, fresh.cand)
    assert torch.equal(got.valid, fresh.valid)
    lin = SH.refresh_sdf(prob.solver, state_b)
    out = SDF.SdfLin(*(torch.zeros_like(t) for t in (lin.s0, lin.g,
                                                     lin.v0)))
    got = SH.refresh_sdf(prob.solver, state_b, out)
    assert got.g is out.g
    for a, b in zip((got.s0, got.g, got.v0), (lin.s0, lin.g, lin.v0)):
        assert torch.equal(a, b)


def test_refresh_device_constants_match_uploads():
    """compact_candidates' bf16 BIG and sample's grid dims, made on the
    device, equal the torch.tensor uploads they replace bit for bit."""
    big = NN.bf16_big("cpu")
    old = torch.tensor(NN.BIG, dtype=torch.bfloat16)
    assert big.dtype == old.dtype and big.shape == old.shape
    assert torch.equal(big.view(torch.int16), old.view(torch.int16))
    for shape in ((17, 17, 17), (32, 9, 130), (1024, 3, 2)):
        for dtype in (torch.float32, torch.int64):
            d = SDF.dims(shape, dtype, "cpu")
            ref = torch.tensor(shape, dtype=dtype)
            assert d.dtype == ref.dtype and torch.equal(d, ref)


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["lbfgs", "lbfgs_perframe"])
def test_lbfgs_graph_route_matches_eager_on_the_card(cuda_device,
                                                     optimizer):
    """T = 8, 10 iterations per stage: the graph route's histories within
    chip_smoke.py phase 12's 1e-3 relative of the eager route's, its
    pieces captured on the graph route only."""
    from fpv4d_torch.models import smplx, vposer
    from fpv4d_torch.utils.bench_problem import keypoint_problem
    model = smplx.synthetic_model(num_verts=256, seed=3, device=cuda_device)
    vp = vposer.random_params(3, device=cuda_device)
    kp, _ = keypoint_problem(model, vp, 8, num_iter=10)
    cfg = KeypointFitConfig(num_iter=10, optimizer=optimizer)
    runs = {}
    for graphs in (True, False):
        runs[graphs] = keypoint_fit.fit_keypoints(
            model, vp, kp, cfg, device=cuda_device, step_graphs=graphs)
        assert bool(keypoint_fit.capture_seconds) == graphs
    (pg, hg), (pe, he) = runs[True], runs[False]
    assert np.all(np.isfinite(pg))
    for k in ("camera", "body", "all"):
        rel = np.abs(hg[k] - he[k]) / np.abs(he[k])
        assert np.all(np.isfinite(hg[k])) and rel.max() < 1e-3, k
