"""The body of the 2-process gloo test of tests/test_torch_sharding.py:
a small port-only fleet (no jax, so the spawned processes import only
torch and the port) fitted with its clips axis over the ranks."""
import numpy as np
import torch

from fpv4d_torch.config import ClipConfig, KeypointFitConfig
from fpv4d_torch.models import smplx, vposer
from fpv4d_torch.ops import contact
from fpv4d_torch.parallel import sharding as SH
from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
from fpv4d_torch.solve.clip_solve import ClipSolver
from fpv4d_torch.solve.keypoint_fit import fit_keypoints
from fpv4d_torch.utils.bench_problem import keypoint_problem

T, V, C = 8, 256, 4


def problem():
    """(solver, bodies [C,T,75], cams, padded scenes, vposer, keypoints
    [2, T, 25, 3])."""
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
                        config=ClipConfig(num_iter=10, window=T, dct_num=3,
                                          contact_refresh_steps=4,
                                          contact_compact=32),
                        device="cpu")
    bodies = (rng.randn(C, T, 75) * 0.1).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (C, T, 1, 1))
    scenes = pad_scenes([scene, scene[:200], scene, scene[50:]])
    kp, _ = keypoint_problem(model, vp, T, num_iter=5)
    kp_b = np.stack([kp, kp + np.float32(1.5)])
    return solver, bodies, cams, scenes, model, vp, kp_b


def run(rank: int, init_file: str, out_file: str):
    torch.set_num_threads(1)
    SH.maybe_initialize_distributed(init_method=f"file://{init_file}",
                                    world_size=2, rank=rank, device="cpu")
    mesh = SH.make_mesh({"clips": 2})
    assert SH.clip_range(mesh, C) == (2 * rank, 2 * rank + 2)
    solver, bodies, cams, scenes, model, vp, kp_b = problem()
    mc = MultiClipSolver(solver=solver, mesh=mesh)
    state_b, hist = mc.fit(bodies, cams, scenes, mode="local")
    params, kp_hist = fit_keypoints(model, vp, kp_b,
                                    KeypointFitConfig(num_iter=5),
                                    mesh=mesh, device="cpu")
    if rank == 0:
        np.savez(out_file, body_6d=state_b.body_6d.numpy(),
                 scale=state_b.scale.numpy(), kp_params=params,
                 kp_all=kp_hist["all"],
                 **{f"hist_{k}": v for k, v in hist.items()})
    torch.distributed.destroy_process_group()
