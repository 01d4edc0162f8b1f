"""The standard problem (port of fpv4d/utils/bench_problem.py:117): a
production-shaped synthetic clip solve — 900 frames, a 10,475-vertex
SMPL-X stand-in with sparse skinning weights, ~870 leg contact vertices
and a 100,489-point floor scene — with the reference's shapes, seeds
and defaults (contact_compact=192, skate_subset=1024 body-only); and
the keypoint-fit target (``keypoint_problem``, port of :81).

The model comes from the port's own ``synthetic_arrays`` (pure numpy,
bit-identical to the reference's arrays for the same seed), through
``cached_synthetic_model``: an npz of its arrays under
``fpv4d_torch/_cache/`` (git-ignored), written once and read after.
The reference's ``enable_persistent_cache`` points XLA's compilation
cache at a directory; it has no counterpart here (the port compiles
nothing but its kernels, which ``fpv4d_torch/_build/`` keeps).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fpv4d_torch.config import ClipConfig, KeypointFitConfig
from fpv4d_torch.models import smplx, vposer
from fpv4d_torch.ops import contact
from fpv4d_torch.solve.clip_solve import ClipSolver


@dataclass
class StandardProblem:
    model: smplx.SmplxModel
    vp: dict
    solver: ClipSolver
    body: np.ndarray       # [T, 75] synthetic packed params
    cam: np.ndarray        # [T, 4, 4]
    scene: np.ndarray      # [M, 3]


def default_cache_dir() -> str:
    return str(Path(__file__).resolve().parents[1] / "_cache")


def cached_synthetic_model(num_verts: int, cache_dir: str, seed: int = 0,
                           device="cpu") -> smplx.SmplxModel:
    """The synthetic model with sparse skinning weights (the standard
    problem's), its arrays cached as ``synthmodel_<V>_swl.npz`` in
    cache_dir, the reference's name (``_s<seed>`` before ``_swl`` for a
    seed other than 0, which the reference's name does not tell apart).
    Unlike the reference's cache, the face landmarks are kept, so a
    cached model runs the keypoint fit's face stage. The file is
    written whole under a temporary name and then renamed, so
    processes that share the directory never read half of one."""
    os.makedirs(cache_dir, exist_ok=True)
    tag = "" if seed == 0 else f"_s{seed}"
    path = os.path.join(cache_dir, f"synthmodel_{num_verts}{tag}_swl.npz")
    if os.path.exists(path):
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    else:
        arrays = smplx.synthetic_arrays(num_verts=num_verts, seed=seed,
                                        sparse_weights=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    return smplx.SmplxModel(**arrays, device=device)


def standard_problem(T: int = 900, num_verts: int = 10475,
                     scene_pts: int = 100_489, num_iter: int = 500,
                     num_iter_dct: int = 10000, skate_subset: int = 1024,
                     skate_body_only: bool = True,
                     contact_compact: Optional[int] = 192,
                     nn_impl: str = "grid",
                     device="cuda",
                     cache_dir: Optional[str] = None) -> StandardProblem:
    """Build the standard problem at the given sizes on `device`;
    nn_impl='brute' gives its brute-force contact-NN variant (K2). The
    model is read from (or first written to) cache_dir, by default
    ``default_cache_dir()``."""
    dev = torch.device(device)
    model = cached_synthetic_model(num_verts, cache_dir or
                                   default_cache_dir(), device=dev)
    vp = vposer.random_params(seed=0, device=dev)
    rng = np.random.RandomState(0)

    g = int(np.sqrt(scene_pts))
    xs, zs = np.meshgrid(np.linspace(-5, 5, g), np.linspace(-5, 5, g))
    scene = np.stack([xs.ravel(), -1.0 + 0.05 * rng.randn(g * g),
                      zs.ravel()], 1).astype(np.float32)

    segs = contact.synthetic_segments(num_verts, seed=0, coherent=True)
    vids_l = np.asarray(segs["L_Leg"], np.int32)
    vids_r = np.asarray(segs["R_Leg"], np.int32)

    kw = {} if contact_compact is None else {
        "contact_compact": contact_compact}
    cfg = ClipConfig(num_iter=num_iter, num_iter_dct=num_iter_dct,
                     window=60 if T % 60 == 0 else T, dct_num=5,
                     skate_subset=skate_subset,
                     skate_body_only=skate_body_only, **kw)
    solver = ClipSolver(
        model=model, vposer_params=vp, scene_verts=scene,
        contact_vids=np.concatenate([vids_l, vids_r]),
        contact_vids_left=vids_l, contact_vids_right=vids_r,
        config=cfg, nn_impl=nn_impl, device=dev)

    def smooth_noise(n, dim, scale):
        k = 11
        x = rng.randn(n + k - 1, dim)
        x = np.stack([np.convolve(x[:, i], np.ones(k) / k, mode="valid")
                      for i in range(dim)], 1)
        return (x * scale).astype(np.float32)

    body = np.zeros((T, 75), dtype=np.float32)
    body[:, 0:3] = smooth_noise(T, 3, 0.3)
    body[:, 3:6] = smooth_noise(T, 3, 0.2)
    body[:, 6:16] = rng.randn(10) * 0.3
    body[:, 16:48] = smooth_noise(T, 32, 0.5)
    body[:, 48:75] = smooth_noise(T, 27, 0.2)
    cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    cam[:, :3, 3] = smooth_noise(T, 3, 0.5)

    return StandardProblem(model=model, vp=vp, solver=solver,
                           body=body, cam=cam, scene=scene)


def fleet_batch(prob: StandardProblem, C: int, seed: int = 0):
    """The reference's fleet input over the standard problem (bench.py's
    C-clip fleet): the body tiled C times, clip 0 exact and clips 1..C-1
    with 0.01 N(0, 1) noise; the cameras tiled; the scene repeated C
    times and padded by pad_scenes (numpy: the grid cache hashes it).
    Returns (bodies [C,T,75], cams [C,T,4,4], scenes [C,M,3])."""
    from fpv4d_torch.parallel.multi_clip import pad_scenes
    rng = np.random.RandomState(seed)
    bodies = np.tile(prob.body[None], (C, 1, 1))
    bodies[1:] += rng.randn(C - 1, *prob.body.shape).astype(np.float32) \
        * np.float32(0.01)
    cams = np.tile(prob.cam[None], (C, 1, 1, 1))
    return bodies, cams, pad_scenes([prob.scene] * C)


def keypoint_problem(model: smplx.SmplxModel, vp: dict, T: int,
                     num_iter: int = 120, noise_px: float = 2.0,
                     seed: int = 1):
    """The keypoint-fit target: VPoser-decoded ground-truth poses at
    z = 3 m, projected to BODY_25 pixels with `noise_px` pixel noise;
    the reference's seed and draws, so the target is the reference's.
    Returns (kp [T, 25, 3] float32 numpy, KeypointFitConfig)."""
    from fpv4d_torch.solve.keypoint_fit import BODY25_FROM_SMPLX, project
    kcfg = KeypointFitConfig(num_iter=num_iter)
    rng = np.random.RandomState(seed)
    valid = BODY25_FROM_SMPLX >= 0
    ids = np.where(valid, BODY25_FROM_SMPLX, 0)
    dev = model.v_template.device
    lat = torch.as_tensor(rng.randn(T, 32).astype(np.float32) * 0.3,
                          device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=dev)
    with torch.no_grad():
        out_gt = model(betas=zeros(T, model.num_betas),
                       global_orient=zeros(T, 3),
                       body_pose=vposer.decode(vp, lat),
                       vertex_subset=np.zeros(1, np.int32))
        j_cam = out_gt["joints"][:, torch.as_tensor(
            ids.astype(np.int64), device=dev)] + torch.tensor(
                [0.0, 0.0, 3.0], device=dev)
        center = torch.tensor([kcfg.image_size[0] / 2,
                               kcfg.image_size[1] / 2], device=dev)
        j2d = project(j_cam, kcfg.focal_length, center).cpu().numpy()
    kp = np.concatenate(
        [j2d + rng.randn(*j2d.shape).astype(np.float32) * noise_px,
         np.tile(valid.astype(np.float32)[None, :, None], (T, 1, 1))],
        -1).astype(np.float32)
    return kp, kcfg
