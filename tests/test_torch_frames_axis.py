"""The frames axis of the port's fleet (fpv4d_torch/parallel/sharding.py
FrameShard, parallel/multi_clip.py, cli/multiopt.py and the keypoint
fit's mesh=): gloo ranks on the CPU, spawned twice (2 ranks, then 4),
each running several cases; their bodies are tests/torch_frames_worker
.py, which imports no jax.

  (a) 2 local_a steps with brute-force contact on {'clips': 1,
      'frames': 2} against the JAX package's build_sharded_step on its
      own {'clips': 1, 'frames': 2} mesh (two of the conftest's 8 virtual
      CPU devices; XLA's halo and reductions), the model and VPoser
      carried across through convert.py: body_6d at the reference's own
      frames-axis tolerance, atol 1e-5 (tests/test_sharding.py), on the
      eager route and on the graph route with its capture stood in for
      (the step's segments between the collectives, the Adam step's
      graph).
  (b) Whole fits on {'clips': 1, 'frames': 2} against the port's
      one-process fold: local (grid with refresh and compaction, chunked
      skate with the halo frames' planted-foot weights), global with
      brute force, global with the grid and a floor SDF, and dct, with
      windows aligned to the shards (T=8, W=2: c_dct split) and
      straddling them (T=12, W=3: c_dct whole, the trajectory gathered).
      The fleet's tolerances (tests/test_torch_sharding.py): histories
      rtol 1e-4 (skate 1e-3, dct_a 1e-5), body_6d 99% within 1e-4 and
      all within 2 lr, scale 1e-5, camera_ext 1e-6, c_dct 1e-6 (1e-5 in
      dct mode). The whole leaves (scale, a whole c_dct) are equal on the
      two ranks after every phase.
  graph route: local (grid with refresh and compaction, chunked skate),
      global with brute force and dct with straddling windows (T=12,
      W=3: the joints gathered between two segments) on the stand-in
      graph route (each replay reruns the captured piece), bit-equal to
      the eager route on each rank, histories and leaves, with every
      phase's segments and Adam step captured.
  (c) {'clips': 2, 'frames': 2} over 4 ranks: the fleet and the batched
      keypoint fit against one process, at the same tolerances.
  multiopt: the default mesh {'clips': min(ranks, clips)} with 2 ranks
      and 1 clip (rank 1 outside the mesh) writes rank 0's pkls equal to
      a one-process run's; --mesh clips=1,frames=2 writes them within the
      CLI tests' tolerances (tests/test_torch_cli.py)."""

import ast

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpv4d.config import ClipConfig as JConfig
from fpv4d.models import smplx as jsmplx
from fpv4d.models import vposer as jvp
from fpv4d.ops import contact as jcontact
from fpv4d.parallel import multi_clip as JMC
from fpv4d.parallel import sharding as JSH
from fpv4d.solve.clip_solve import ClipSolver as JSolver
from fpv4d_torch.config import KeypointFitConfig
from fpv4d_torch.io import body_pkl
from fpv4d_torch.io.ply import write_ply
from fpv4d_torch.models import params as TP
from fpv4d_torch.parallel.multi_clip import MultiClipSolver
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.keypoint_fit import fit_keypoints

import torch_frames_worker as W
from helpers import smooth_noise

LR = 0.005


def _reference_inputs(rng):
    """The JAX side of (a): the model, VPoser, scene, contact ids and a
    1-clip batch of 8 frames."""
    T = 8
    model = jsmplx.synthetic_model(num_verts=W.V, seed=2,
                                   sparse_weights=True)
    vp = jvp.random_params(2)
    segs = jcontact.synthetic_segments(W.V, seed=2, coherent=True)
    # every parameter moves from frame to frame: an exact zero difference
    # meets the L1 terms' derivative at 0, where last-bit differences
    # steer Adam steps by +-lr (tests/test_torch_clip_solve.py)
    body = smooth_noise(T, 75, rng, 0.2)
    body[:, 6:16] += rng.randn(10).astype(np.float32) * 0.3
    body[:, 16:48] = smooth_noise(T, 32, rng, 0.5)
    g = 12
    xs, zs = np.meshgrid(np.linspace(-3, 3, g), np.linspace(-3, 3, g))
    scene = np.stack([xs.ravel(), -1.0 + 0.03 * rng.randn(g * g),
                      zs.ravel()], 1).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (1, T, 1, 1))
    cams[0, :, :3, 3] = smooth_noise(T, 3, rng, 0.2)
    arrays = {f"model_{k}": np.asarray(getattr(model, k))
              for k in jsmplx.SmplxModel._LEAVES}
    arrays["model_faces"] = np.asarray(model.faces)
    return dict(model=model, vp=vp, scene=scene, bodies=body[None],
                cams=cams, vl=np.asarray(segs["L_Leg"], np.int32),
                vr=np.asarray(segs["R_Leg"], np.int32), arrays=arrays)


def _write_clip(root, T, rng):
    """A multiopt clip directory: body pkls, a floor scene.ply and a
    camerapose.txt."""
    body_pkl.save_clip(str(root / "body_gen"),
                       (rng.randn(T, 75) * 0.1).astype(np.float32))
    xs, zs = np.meshgrid(np.linspace(-3, 3, 30), np.linspace(-3, 3, 30))
    write_ply(str(root / "scene.ply"), np.stack(
        [xs.ravel(), -1.0 + 0.03 * rng.randn(xs.size), zs.ravel()],
        1).astype(np.float32))
    with open(root / "camerapose.txt", "w") as f:
        for t in range(T):
            f.write(f"{t:06d}.jpg 1 0 0 0 0.1 0.2 {0.3 + 0.1 * t}\n")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks (W.run_frames): each rank's npz."""
    d = tmp_path_factory.mktemp("frames2")
    rng = np.random.RandomState(0)
    ref = _reference_inputs(rng)
    np.savez(d / "reference.npz", scene=ref["scene"], bodies=ref["bodies"],
             cams=ref["cams"], vl=ref["vl"], vr=ref["vr"], **ref["arrays"],
             **{f"vp_{k}": np.asarray(v) for k, v in ref["vp"].items()})
    (d / "clipA").mkdir()
    _write_clip(d / "clipA", 4, rng)
    torch.multiprocessing.spawn(W.run_frames, args=(str(d / "pg"), str(d)),
                                nprocs=2, join=True)
    return d, ref, [np.load(d / f"rank{r}.npz") for r in range(2)]


def test_local_a_steps_match_the_reference_frames_mesh(two_ranks):
    _, ref, got = two_ranks
    solver = JSolver(model=ref["model"], vposer_params=ref["vp"],
                     scene_verts=ref["scene"],
                     contact_vids=np.concatenate([ref["vl"], ref["vr"]]),
                     contact_vids_left=ref["vl"],
                     contact_vids_right=ref["vr"],
                     config=JConfig(num_iter=4, window=4, dct_num=2),
                     use_pallas=False)
    mesh = JSH.make_mesh({"clips": 1, "frames": 2})
    mc = JMC.MultiClipSolver(solver=solver, mesh=mesh)
    state_b, target_b, weights_b = mc.init_batch(jnp.asarray(ref["bodies"]),
                                                 jnp.asarray(ref["cams"]))
    sb, tb, wb, scb = JSH.shard_batch(mesh, state_b, target_b, weights_b,
                                      jnp.asarray(JMC.pad_scenes(
                                          [ref["scene"]])))
    step_fn, init_fn = JSH.build_sharded_step(
        solver, mesh, "local_a", num_steps=2,
        dct_windows=state_b.c_dct.shape[1])
    sb1, _, hist = step_fn(sb, init_fn(sb), tb, wb, scb)
    assert np.asarray(hist).shape == (2, 1)
    want = np.asarray(sb1.body_6d)
    assert got[0]["local_a"].shape == want.shape == (1, 8, 78)
    assert np.abs(want - np.asarray(state_b.body_6d)).max() > 1e-3
    for g in got:
        for route in ("local_a", "local_a_graph"):
            np.testing.assert_allclose(g[route], want, atol=1e-5,
                                       err_msg=route)


@pytest.mark.parametrize("name", sorted(W.CASES))
def test_frames_fit_matches_the_one_rank_fold(two_ranks, name):
    _, _, got = two_ranks
    T, mode, nn_impl, sdf = W.CASES[name]
    solver, bodies, cams, scenes = W.problem(T, nn_impl, sdf)
    state_b, hist = MultiClipSolver(solver=solver).fit(bodies, cams, scenes,
                                                       mode=mode)
    tol = {"local_skate": 1e-3, "dct_a": 1e-5}
    for k, v in hist.items():
        for g in got:
            assert g[f"{name}/hist_{k}"].shape == v.shape == (v.shape[0],
                                                              W.C)
            np.testing.assert_allclose(g[f"{name}/hist_{k}"], v,
                                       rtol=tol.get(k, 1e-4), err_msg=k)
    for g in got:
        err = np.abs(g[f"{name}/body_6d"] - state_b.body_6d.numpy())
        assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR
        np.testing.assert_allclose(g[f"{name}/scale"], state_b.scale.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(g[f"{name}/camera_ext"],
                                   state_b.camera_ext.numpy(), atol=1e-6)
        np.testing.assert_allclose(g[f"{name}/c_dct"], state_b.c_dct.numpy(),
                                   atol=1e-5 if mode == "dct" else 1e-6)
        # the whole leaves' copies never parted, phase by phase
        assert g[f"{name}/spread"].shape == (len(hist),)
        assert np.all(g[f"{name}/spread"] == 0.0)
    for k in ("body_6d", "scale", "camera_ext", "c_dct"):
        np.testing.assert_array_equal(got[0][f"{name}/{k}"],
                                      got[1][f"{name}/{k}"])


@pytest.mark.parametrize("name", W.GRAPH_CASES)
def test_frames_graph_route_matches_eager(two_ranks, name):
    _, _, got = two_ranks
    mode = W.CASES[name][1]
    for g in got:
        keys = [k for k in g.files if k.startswith(f"{name}/graph/")]
        assert {k.split("/")[-1] for k in keys} >= {
            "body_6d", "scale", "camera_ext", "c_dct", "spread"}
        for k in keys:
            if not k.endswith("/captures"):
                np.testing.assert_array_equal(
                    g[k], g[k.replace("/graph/", "/")], err_msg=k)
        assert np.all(g[f"{name}/graph/spread"] == 0.0)
        captured = [ast.literal_eval(k) for k in g[f"{name}/graph/captures"]]
        phases = {k[0] for k in captured}
        # a phase of more steps than the warm-up's is captured
        assert phases >= {
            k.replace("local_skate", "skate") for k in W.problem_phases(mode)
            if len(g[f"{name}/graph/hist_{k}"]) > step_graph.WARMUP_STEPS}
        for phase in phases - {"detect"}:
            mine = [k for k in captured if k[0] == phase]
            assert any(k[-2:] == ("own", "forward") for k in mine), phase
            assert any(k[-1] == "adam" for k in mine), phase
            # a whole step is never captured: it holds collectives
            assert all(k[-1] in ("forward", "backward", "adam", "cands",
                                 "sdf") for k in mine), mine
        if name == "straddle_dct":
            assert ("dct_b", True, False, "dct", "forward") in captured
            assert ("dct_b", True, False, "dct", "backward") in captured


def _frames(path):
    return [body_pkl.load_frame(str(p)) for p in sorted(path.glob("*.pkl"))]


def _one_process_multiopt(d):
    """multiopt alone on one thread, as each spawned rank runs."""
    from fpv4d_torch.cli.multiopt import main
    out = d / "mo_one"
    if not out.exists():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert main([str(d / "clipA"), "--mode", "global", "--iters",
                         "4", "--scene-name", "scene.ply", "--model", "NONE",
                         "--vposer", "NONE", "--device", "cpu", "--out",
                         str(out)]) == 0
        finally:
            torch.set_num_threads(threads)
    return _frames(out / "clipA")


def test_multiopt_default_mesh_with_more_ranks_than_clips(two_ranks):
    """{'clips': min(2 ranks, 1 clip)}: rank 1 solves nothing, both exit
    0 (the spawn joins cleanly), and rank 0's pkls are the one-process
    run's to the last bit."""
    d, _, _ = two_ranks
    want = _one_process_multiopt(d)
    got = _frames(d / "mo_default" / "clipA")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_multiopt_on_a_frames_mesh(two_ranks):
    d, _, _ = two_ranks
    want = _one_process_multiopt(d)
    got = _frames(d / "mo_frames" / "clipA")
    assert len(got) == len(want) == 4
    body_err = []
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["scale"], b["scale"], atol=1e-5)
        np.testing.assert_allclose(a["camera_ext"], b["camera_ext"],
                                   atol=1e-6)
        body_err += [np.abs(a[k] - b[k]).ravel() for k in TP.SLICES]
    err = np.concatenate(body_err)
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR


def test_clips_and_frames_mesh_on_four_ranks(tmp_path):
    torch.multiprocessing.spawn(W.run_clips_frames,
                                args=(str(tmp_path / "pg"), str(tmp_path)),
                                nprocs=4, join=True)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    solver, bodies, cams, scenes = W.problem(8)
    state_b, hist = MultiClipSolver(solver=solver).fit(bodies, cams, scenes,
                                                       mode="local")
    model = W.smplx.synthetic_model(num_verts=W.V, seed=0,
                                    sparse_weights=True)
    vp = W.vposer.random_params(0)
    kp, _ = W.keypoint_problem(model, vp, 8, num_iter=5)
    params, kp_hist = fit_keypoints(model, vp, np.stack(
        [kp, kp + np.float32(1.5)]), KeypointFitConfig(num_iter=5),
        device="cpu")
    for g in got:
        for k, v in hist.items():
            np.testing.assert_allclose(g[f"hist_{k}"], v, rtol=1e-3
                                       if k == "local_skate" else 1e-4,
                                       err_msg=k)
        err = np.abs(g["body_6d"] - state_b.body_6d.numpy())
        assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR
        np.testing.assert_allclose(g["scale"], state_b.scale.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(g["camera_ext"],
                                   state_b.camera_ext.numpy(), atol=1e-6)
        np.testing.assert_allclose(g["kp_params"], params, atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(g["kp_all"], kp_hist["all"], rtol=1e-4,
                                   atol=1e-6)
