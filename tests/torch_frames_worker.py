"""The bodies of the spawned gloo runs of tests/test_torch_frames_axis.py:
the port's frames axis (no jax here, so the spawned processes import
only torch and the port). Each rank writes what it got to
``out_dir/rank<r>.npz``; the test holds it against the JAX package and
against the port's one-process fold."""
import os

import numpy as np
import torch

from fpv4d_torch import convert
from fpv4d_torch.config import ClipConfig, KeypointFitConfig
from fpv4d_torch.models import smplx, vposer
from fpv4d_torch.ops import contact
from fpv4d_torch.ops import sdf as SDF
from fpv4d_torch.parallel import sharding as SH
from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.clip_solve import ClipSolver
from fpv4d_torch.solve.keypoint_fit import fit_keypoints
from fpv4d_torch.utils.bench_problem import keypoint_problem
from test_torch_step_graph import RerunCapture

V, C, WINDOW = 256, 4, 4

# name -> (T, mode, nn_impl, floor SDF): windows of 4 frames, so T=8
# gives W=2 (split over 2 frames ranks) and T=12 gives W=3 (whole,
# gathered)
CASES = {"aligned_local": (8, "local", "grid", False),
         "aligned_global": (8, "global", "brute", False),
         "aligned_dct": (8, "dct", "grid", False),
         "aligned_sdf": (8, "global", "grid", True),
         "straddle_dct": (12, "dct", "grid", False),
         "straddle_local": (12, "local", "grid", False)}

# the cases also fitted on the graph route, its capture stood in for
# (RerunCapture: each replay reruns the captured piece): the segments,
# their warm-up, capture and replays, the Adam step's graph and the
# captured refreshes, against the eager route's bits
GRAPH_CASES = ("aligned_local", "aligned_global", "straddle_dct")


def problem_phases(mode: str):
    """The histories a fit in `mode` returns."""
    return {"local": ("local_a", "local_b", "local_skate"),
            "global": ("global_a", "global_b"),
            "dct": ("dct_a", "dct_b")}[mode]


def stand_in_program() -> step_graph.PhaseProgram:
    """A graph-route phase program on the CPU, its capture stood in for."""
    return step_graph.PhaseProgram("cpu", True, RerunCapture)


def problem(T: int, nn_impl: str = "grid", sdf: bool = False,
            clips: int = C):
    """(solver, bodies [clips,T,75], cams, padded scenes): a small
    port-only fleet on a seeded synthetic model and floor scene, clip 1
    with an outlier frame; 8 local_a, 2 local_b and 4 skate steps, 15
    dct_a and 5 dct_b steps, a refresh every 4."""
    rng = np.random.RandomState(0)
    model = smplx.synthetic_model(num_verts=V, seed=0, sparse_weights=True)
    vp = vposer.random_params(0)
    segs = contact.synthetic_segments(V, seed=0, coherent=True)
    vl = np.asarray(segs["L_Leg"], np.int32)
    vr = np.asarray(segs["R_Leg"], np.int32)
    g = 16
    xs, zs = np.meshgrid(np.linspace(-3, 3, g), np.linspace(-3, 3, g))
    scene = np.stack([xs.ravel(), -1.0 + 0.03 * rng.randn(g * g),
                      zs.ravel()], 1).astype(np.float32)
    solver = ClipSolver(model=model, vposer_params=vp, scene_verts=scene,
                        contact_vids=np.concatenate([vl, vr]),
                        contact_vids_left=vl, contact_vids_right=vr,
                        config=ClipConfig(num_iter=10, num_iter_dct=20,
                                          dct_split=0.75, window=WINDOW,
                                          dct_num=3, contact_refresh_steps=4,
                                          contact_compact=32),
                        nn_impl=nn_impl, sdf=SDF.plane_sdf(
                            y0=-0.95, extent=4.0, dim=17) if sdf else None,
                        device="cpu")
    bodies = (rng.randn(clips, T, 75) * 0.1).astype(np.float32)
    bodies[1, 3, 16:48] = 3.0
    cams = np.tile(np.eye(4, dtype=np.float32), (clips, T, 1, 1))
    cams[:, :, :3, 3] = rng.randn(clips, T, 3).astype(np.float32) * 0.05
    scenes = pad_scenes([scene, scene[:200], scene, scene[50:]][:clips])
    return solver, bodies, cams, scenes


def reference_solver(ref):
    """The JAX test's solver, its weights carried across as numpy."""
    arrays = {k[6:]: ref[k] for k in ref.files if k.startswith("model_")}
    return ClipSolver(
        model=convert.smplx_from_numpy(arrays),
        vposer_params=convert.vposer_from_numpy(
            {k[3:]: ref[k] for k in ref.files if k.startswith("vp_")}),
        scene_verts=ref["scene"],
        contact_vids=np.concatenate([ref["vl"], ref["vr"]]),
        contact_vids_left=ref["vl"], contact_vids_right=ref["vr"],
        config=ClipConfig(num_iter=4, window=4, dct_num=2), nn_impl="brute",
        device="cpu")


def _local_a_steps(mesh, ref, num_steps: int = 2,
                   program=None) -> np.ndarray:
    """num_steps local_a steps of the JAX test's batch on the frames
    axis through `program` (eager without one) -> the whole body_6d
    [1, T, 78]."""
    solver = reference_solver(ref)
    mc = MultiClipSolver(solver=solver, mesh=mesh)
    state_b, target_b, weights_b = mc.init_batch(ref["bodies"], ref["cams"])
    shard = SH.FrameShard.of(mesh, ref["bodies"].shape[1],
                             solver.config.window)
    own = slice(shard.lo, shard.hi)
    st, opt = solver.make_optimizer(shard.split_state(state_b))
    SH.run_phase(solver, "local_a", st, opt, target_b[:, own],
                 weights_b[:, own], num_steps,
                 scenes_b=torch.as_tensor(pad_scenes([ref["scene"]])),
                 shard=shard, program=program)
    return shard.join_state(st).body_6d.detach().numpy()


def run_frames(rank: int, init_file: str, out_dir: str):
    """2 ranks, {'clips': 1, 'frames': 2}: the JAX test's local_a steps
    (eager and on the stand-in graph route), every case of CASES (those
    of GRAPH_CASES on both routes), then multiopt with its default mesh
    (1 clip: rank 1 is outside it) and with --mesh clips=1,frames=2."""
    torch.set_num_threads(1)
    SH.maybe_initialize_distributed(init_method=f"file://{init_file}",
                                    world_size=2, rank=rank, device="cpu")
    mesh = SH.make_mesh({"clips": 1, "frames": 2})
    assert SH.frame_range(mesh, 8) == (4 * rank, 4 * rank + 4)
    ref = np.load(os.path.join(out_dir, "reference.npz"))
    out = {"local_a": _local_a_steps(mesh, ref)}
    # no warm-up: the reference's two steps are a capture and a replay
    warmup, step_graph.WARMUP_STEPS = step_graph.WARMUP_STEPS, 0
    try:
        out["local_a_graph"] = _local_a_steps(mesh, ref,
                                              program=stand_in_program())
    finally:
        step_graph.WARMUP_STEPS = warmup
    for name, (T, mode, nn_impl, sdf) in CASES.items():
        solver, bodies, cams, scenes = problem(T, nn_impl, sdf)
        mc = MultiClipSolver(solver=solver, mesh=mesh)
        for route in ("", "graph/")[:1 + (name in GRAPH_CASES)]:
            if route:
                solver.program = stand_in_program
            state_b, hist = mc.fit(bodies, cams, scenes, mode=mode)
            for k, v in state_b._asdict().items():
                out[f"{name}/{route}{k}"] = v.numpy()
            for k, v in hist.items():
                out[f"{name}/{route}hist_{k}"] = v
            out[f"{name}/{route}spread"] = np.asarray(
                [mc.whole_leaf_spread[k] for k in hist])
            out[f"{name}/{route}captures"] = np.asarray(
                sorted(map(repr, mc.capture_seconds_by_key)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    from fpv4d_torch.cli.multiopt import main
    args = [os.path.join(out_dir, "clipA"), "--mode", "global", "--iters",
            "4", "--scene-name", "scene.ply", "--model", "NONE", "--vposer",
            "NONE", "--device", "cpu"]
    assert main(args + ["--out", os.path.join(out_dir, "mo_default")]) == 0
    assert main(args + ["--out", os.path.join(out_dir, "mo_frames"),
                        "--mesh", "clips=1,frames=2"]) == 0
    torch.distributed.destroy_process_group()


def run_clips_frames(rank: int, init_file: str, out_dir: str):
    """4 ranks, {'clips': 2, 'frames': 2}: the aligned local fleet (C=4,
    2 clips per clips row) and the batched keypoint fit of 2 clips."""
    torch.set_num_threads(1)
    SH.maybe_initialize_distributed(init_method=f"file://{init_file}",
                                    world_size=4, rank=rank, device="cpu")
    mesh = SH.make_mesh({"clips": 2, "frames": 2})
    assert (mesh.coord("clips"), mesh.coord("frames")) == divmod(rank, 2)
    solver, bodies, cams, scenes = problem(8)
    state_b, hist = MultiClipSolver(solver=solver, mesh=mesh).fit(
        bodies, cams, scenes, mode="local")
    model = smplx.synthetic_model(num_verts=V, seed=0, sparse_weights=True)
    vp = vposer.random_params(0)
    kp, _ = keypoint_problem(model, vp, 8, num_iter=5)
    params, kp_hist = fit_keypoints(model, vp, np.stack(
        [kp, kp + np.float32(1.5)]), KeypointFitConfig(num_iter=5),
        mesh=mesh, device="cpu")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             body_6d=state_b.body_6d.numpy(), scale=state_b.scale.numpy(),
             camera_ext=state_b.camera_ext.numpy(), kp_params=params,
             kp_all=kp_hist["all"],
             **{f"hist_{k}": v for k, v in hist.items()})
    torch.distributed.destroy_process_group()
