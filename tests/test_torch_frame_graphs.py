"""The compiled per-frame stages: the keypoint fit's Adam stages
(solve/keypoint_fit.py) and the three smoothers (solve/frame_fit.py) on
solve/adam.py's Adam through solve/step_graph.py's phase program.

* a sync guard (a TorchDispatchMode raising on every op that reads a
  value back to the host or makes a tensor of host data) around each
  captured step, the capture stood in for on the CPU: the keypoint fit's
  three stages (plain, two clips batched, hands and face) and each
  smoother's body (fit_independent's step, the sequential variants'
  frame body of num_iter Adam steps and its frame bookkeeping); the
  model's per-subset tables are all built before the capture;
* the graph route's plumbing (warm-up, one capture per stage or body,
  replays), with a stand-in whose replay reruns the captured callable:
  bit-equal to the eager route;
* the routes: step_graphs=True on the CPU raises, each entry point
  defaults to the card and to graphs;
* no K1 or K2 launch is counted on these paths;
* utils/profile_stages.py rehearsed on the CPU;
* on the card (`gpu`), the graph route against the eager one.

Small sizes: T <= 12, V = 256, C <= 2. The module imports no JAX (the
card's machine runs its `gpu` test with ``--noconftest``).
"""
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fpv4d_torch.config import FrameFitConfig, KeypointFitConfig
from fpv4d_torch.models import motion_gru, smplx, vposer
from fpv4d_torch.solve import frame_fit, keypoint_fit, step_graph
from fpv4d_torch.utils import observability as OBS
from fpv4d_torch.utils.bench_problem import keypoint_problem

T = 8

# -- stand-ins for a capture (as tests/test_torch_step_graph.py's) --------------

_SYNCS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
          "aten.is_nonzero", "aten.lift_fresh", "aten._unique2"}


class NoSync(TorchDispatchMode):
    """Raises on an op that reads a value back to the host or makes a
    tensor of host data (a capture cannot), and on boolean-mask indexing
    (a data-dependent shape)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket._qualified_op_name.replace("::", ".")
        if name in _SYNCS:
            raise AssertionError(f"{name} in a captured step")
        if name in ("aten.index", "aten.index_put", "aten.index_put_"):
            idx = args[1] if len(args) > 1 else []
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in idx):
                raise AssertionError(f"boolean-mask {name} in a captured "
                                     "step")
        return func(*args, **(kwargs or {}))


class GuardedCapture:
    """Runs the step once under NoSync where a capture would record it,
    and checks that no model in `models` built a table there; a replay
    does nothing."""
    captured = []
    models = []

    def __init__(self, step, pool, stream):
        tables = [len(m._cache) for m in GuardedCapture.models]
        with NoSync():
            self.out = step()
        if tables != [len(m._cache) for m in GuardedCapture.models]:
            raise AssertionError("a model table was built in a capture")
        GuardedCapture.captured.append(self)

    def replay(self):
        pass


class RerunCapture:
    """Records the step as a capture does (nothing runs); each replay
    reruns it, its output the one a graph's replay rewrites."""

    def __init__(self, step, pool, stream):
        self.step = step
        self.out = None

    def replay(self):
        self.out = self.step()


@pytest.fixture
def graph_route(monkeypatch):
    """Every phase program the entry points make takes the graph route on
    the CPU with the stand-in capture `make_graph`; returns the programs
    made."""
    made = []
    real = step_graph.PhaseProgram

    def use(make_graph):
        def program(device, graphs, make=None):
            made.append(real(device, True, make_graph))
            return made[-1]

        monkeypatch.setattr(step_graph, "PhaseProgram", program)
        return made

    return use


# -- fixtures ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def kp_setup():
    """A 256-vertex synthetic model with its landmark embedding, VPoser
    weights, BODY_25 keypoints at T = 8, and hand and face keypoints
    drawn around the image centre."""
    model = smplx.synthetic_model(num_verts=256, seed=3)
    vp = vposer.random_params(3)
    kp, _ = keypoint_problem(model, vp, T, num_iter=4)
    rng = np.random.RandomState(7)

    def pts(n):
        a = np.zeros((T, n, 3), np.float32)
        a[..., :2] = (np.array([640.0, 360.0], np.float32)
                      + rng.randn(T, n, 2).astype(np.float32) * 40.0)
        a[..., 2] = 1.0
        return a

    return dict(model=model, vp=vp, kp=kp, hl=pts(21), hr=pts(21),
                face=pts(70))


def _kp_case(s, case):
    """(keypoints, fit_keypoints kwargs) of a case."""
    if case == "plain":
        return s["kp"], {}
    if case == "batched":
        kp_b = np.stack([s["kp"], s["kp"] + np.float32(2.0)])
        return kp_b, {}
    return s["kp"], dict(hand_left=s["hl"], hand_right=s["hr"],
                         face=s["face"])


def _fit(s, case, iters=4, **kw):
    kp, extra = _kp_case(s, case)
    return keypoint_fit.fit_keypoints(
        s["model"], s["vp"], kp, KeypointFitConfig(num_iter=iters),
        device="cpu", **extra, **kw)


@pytest.fixture(scope="module")
def clip():
    rng = np.random.RandomState(0)
    body = np.zeros((T, 75), np.float32)
    body[:, 3:6] = rng.randn(T, 3).astype(np.float32) * 0.2
    body[:, 6:16] = rng.randn(10).astype(np.float32) * 0.3
    body[:, 16:75] = rng.randn(T, 59).astype(np.float32) * 0.3
    return body


_SMOOTHERS = ("independent", "sequential", "motion")


def _smooth(clip, which, iters=5, device="cpu", **kw):
    cfg = FrameFitConfig(num_iter=iters)
    if which == "independent":
        return frame_fit.fit_independent(clip, cfg, device=device, **kw)
    if which == "sequential":
        return frame_fit.fit_sequential(clip, cfg, device=device, **kw)
    return frame_fit.fit_sequential_motion(
        clip, motion_gru.random_params(2, device=device), cfg,
        device=device, **kw)


# -- captured steps never sync ------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "batched", "hands_face"])
def test_keypoint_adam_steps_never_sync(kp_setup, graph_route, case,
                                        monkeypatch):
    made = graph_route(GuardedCapture)
    monkeypatch.setattr(GuardedCapture, "captured", [])
    monkeypatch.setattr(GuardedCapture, "models", [kp_setup["model"]])
    params, hist = _fit(kp_setup, case)
    assert len(made) == 1 and len(GuardedCapture.captured) == 3
    assert set(keypoint_fit.capture_seconds) == {"camera", "body", "all"}
    assert not (made[0]._steps or made[0]._static)    # closed after fit
    assert np.all(np.isfinite(params))
    assert all(np.all(np.isfinite(hist[k])) for k in ("camera", "body",
                                                       "all"))


@pytest.mark.parametrize("which", _SMOOTHERS)
def test_smoother_bodies_never_sync(clip, graph_route, which, monkeypatch):
    made = graph_route(GuardedCapture)
    monkeypatch.setattr(GuardedCapture, "captured", [])
    out = _smooth(clip, which)
    assert len(made) == 1 and len(GuardedCapture.captured) == 1
    assert set(frame_fit.capture_seconds) == {which}
    assert out.shape == (T, 75) and np.all(np.isfinite(out))


# -- the graph route's plumbing equals the eager route -------------------------------

@pytest.mark.parametrize("case", ["plain", "batched", "hands_face"])
def test_keypoint_graph_plumbing_matches_eager(kp_setup, graph_route, case):
    """Two warm-up steps, a capture and replays per stage, the one Adam
    threaded through the three captures: the eager route's bits."""
    p_e, h_e = _fit(kp_setup, case, iters=6)
    made = graph_route(RerunCapture)
    p_g, h_g = _fit(kp_setup, case, iters=6)
    assert set(made[0].capture_seconds) == {("camera",), ("body",),
                                            ("all",)}
    assert np.array_equal(p_g, p_e)
    assert h_g.keys() == h_e.keys()
    for k in h_e:
        assert np.array_equal(h_g[k], h_e[k]), k


@pytest.mark.parametrize("which", _SMOOTHERS)
def test_smoother_graph_plumbing_matches_eager(clip, graph_route, which):
    """The sequential variants' frame body replayed frame after frame
    (its frame counter, the fitted buffer, the GRU's hidden states and
    the one Adam's state all on the device): the eager route's bits."""
    eager = _smooth(clip, which)
    made = graph_route(RerunCapture)
    graphed = _smooth(clip, which)
    assert set(made[0].capture_seconds) == {(which,)}
    assert np.array_equal(graphed, eager)


def test_frame_body_carries_one_adam_count(clip, graph_route, monkeypatch):
    """The sequential smoother's one Adam counts T * num_iter steps on
    the graph route, as on the eager one (optax's one opt_state)."""
    counts = []
    real = frame_fit.Adam

    def adam(params, lr):
        counts.append(real(params, lr))
        return counts[-1]

    monkeypatch.setattr(frame_fit, "Adam", adam)
    graph_route(RerunCapture)
    _smooth(clip, "sequential", iters=3)
    assert int(counts[0].count) == T * 3


# -- routes -----------------------------------------------------------------------

def test_step_graphs_true_on_the_cpu_raises(kp_setup, clip):
    with pytest.raises(ValueError, match="step_graphs"):
        _fit(kp_setup, "plain", step_graphs=True)
    for which in _SMOOTHERS:
        with pytest.raises(ValueError, match="step_graphs"):
            _smooth(clip, which, step_graphs=True)


_ENTRY_POINTS = {"fit_keypoints": keypoint_fit.fit_keypoints,
                 "fit_independent": frame_fit.fit_independent,
                 "fit_sequential": frame_fit.fit_sequential,
                 "fit_sequential_motion": frame_fit.fit_sequential_motion}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_the_card_and_graphs(name):
    sig = inspect.signature(_ENTRY_POINTS[name]).parameters
    assert sig["device"].default == "cuda"
    assert sig["step_graphs"].default is None


@pytest.mark.parametrize("which", ["keypoints", "smoothers"])
def test_no_kernel_launch_is_counted(kp_setup, clip, graph_route, which):
    """Under tracing, neither K1 nor K2 is counted on either route (the
    kernel's or the plain version's)."""
    graph_route(RerunCapture)
    OBS.reset_counts()
    with OBS.tracing():
        if which == "keypoints":
            for case in ("plain", "batched", "hands_face"):
                _fit(kp_setup, case)
        else:
            for s in _SMOOTHERS:
                _smooth(clip, s)
        counts = OBS.counts()
    OBS.reset_counts()
    assert not [k for k in counts if k.startswith(("k1/", "k2/"))], counts


def test_profile_stages_rehearsal(capsys):
    """utils/profile_stages.py on the CPU at a small size: every stage on
    the eager route, wall seconds and no device numbers."""
    import json
    from fpv4d_torch.utils import profile_stages
    assert profile_stages.main(["--device", "cpu", "--T", "8", "--clips",
                                "2", "--seq-T", "4", "--iters", "4",
                                "--lbfgs-iters", "2", "--perframe-iters",
                                "2", "--num-verts", "256"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    stages = [k for k in out if k not in ("device", "power_limit")]
    assert stages == ["keypoints adam T=8", "keypoints batched 2 x 8",
                      "keypoints lbfgs T=8", "keypoints lbfgs_perframe T=8",
                      "fit_independent T=8", "fit_sequential T=4",
                      "fit_sequential_motion T=4"]
    for k in ("keypoints lbfgs T=8", "keypoints lbfgs_perframe T=8"):
        assert 1 <= out[k]["eager"]["rounds_mean"] <= out[k]["eager"][
            "rounds_max"]
    for k in stages:
        assert set(out[k]) == {"eager"}
        assert out[k]["eager"]["wall_s"] > 0
        assert out[k]["eager"]["device_s"] is None


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_route_matches_eager_on_the_card(cuda_device, clip):
    """T = 8, 10 steps per stage: the keypoint histories of the graph
    route within chip_smoke.py phase 12's 1e-3 relative of the eager
    route's; the smoothers' results by its rule (95% of entries within
    1e-4, all within 1e-2); a capture on the graph route only."""
    model = smplx.synthetic_model(num_verts=256, seed=3, device=cuda_device)
    vp = vposer.random_params(3, device=cuda_device)
    kp, cfg = keypoint_problem(model, vp, T, num_iter=10)
    runs = {}
    for graphs in (True, False):
        runs[graphs] = keypoint_fit.fit_keypoints(
            model, vp, kp, cfg, device=cuda_device, step_graphs=graphs)
        assert bool(keypoint_fit.capture_seconds) == graphs
    (_, hg), (_, he) = runs[True], runs[False]
    for k in ("camera", "body", "all"):
        rel = np.abs(hg[k] - he[k]) / np.abs(he[k])
        assert np.all(np.isfinite(hg[k])) and rel.max() < 1e-3, k
    for which in _SMOOTHERS:
        g = _smooth(clip, which, iters=10, device=cuda_device)
        assert set(frame_fit.capture_seconds) == {which}
        e = _smooth(clip, which, iters=10, device=cuda_device,
                    step_graphs=False)
        assert not frame_fit.capture_seconds
        err = np.abs(g - e)
        assert np.all(np.isfinite(g)), which
        assert np.mean(err <= 1e-4) >= 0.95 and err.max() <= 1e-2, which
