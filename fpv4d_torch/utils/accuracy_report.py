"""Ground-truth recovery report of the port's two solver entry points
(port of tools/accuracy_report.py).

Synthesizes a clip with KNOWN SMPL-X parameters, projects its 2D
keypoints (noised), and measures how well the port recovers the truth:

  1. keypoint fit (solve/keypoint_fit.py): 3D MPJPE in camera space and
     2D reprojection error against the ground-truth joints;
  2. clip solve (solve/clip_solve.py, 'local' mode): the joints' MPJPE
     and jitter of a noisy initialization before and after the solve;
     the temporal terms must pull the noisy trajectory toward the truth.

The truth, the observations' noise and the noisy initialization are
drawn from np.random.RandomState(0) in the reference's order, so they
are the reference's own (the ground-truth joints themselves round as
each package's model does).

Usage: python -m fpv4d_torch.utils.accuracy_report [--frames 30]
[--noise-px 2] [--device cuda]. Runs on the card unless --device cpu is
given; without a card the CLI exits 1. Prints one JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def run(frames: int = 30, num_verts: int = 512, noise_px: float = 2.0,
        body_noise: float = 0.05, iters: int = 120,
        optimizer: str = "adam", deep_iters: int = 0,
        clip_iters: int = 60, rec_weight: float = 1.0,
        skip_keypoint: bool = False, device="cuda") -> dict:
    """The reference's report on `device`. optimizer is one name or
    'both' (adam, then the joint-batch L-BFGS); deep_iters > 0 adds a
    clip-solve row at that num_iter; clip_iters and rec_weight set the
    clip solve; skip_keypoint drops stage 1. Returns the reference's
    keys."""
    from fpv4d_torch.config import (ClipConfig, KeypointFitConfig,
                                    LossWeights)
    from fpv4d_torch.core import rotations
    from fpv4d_torch.models import params as P
    from fpv4d_torch.models import smplx, vposer as VP
    from fpv4d_torch.ops import contact
    from fpv4d_torch.solve.clip_solve import ClipSolver
    from fpv4d_torch.solve.keypoint_fit import (BODY25_FROM_SMPLX,
                                                fit_keypoints, project)

    dev = torch.device(device)
    T = frames
    optimizers = ["adam", "lbfgs"] if optimizer == "both" else [optimizer]
    rng = np.random.RandomState(0)
    model = smplx.synthetic_model(num_verts=num_verts, seed=3, device=dev)
    vp = VP.random_params(seed=3, device=dev)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)

    # ground-truth motion: slow and smooth, so it satisfies the temporal
    # priors the clip solve applies (a truth that broke the pipeline's
    # own motion model would measure the objective's bias, not the
    # solver's recovery)
    def smooth(dim, scale, k=None):
        k = k or max(7, (T // 2) | 1)
        x = rng.randn(T + k - 1, dim)
        x = np.stack([np.convolve(x[:, i], np.ones(k) / k, "valid")
                      for i in range(dim)], 1)
        return (x * scale).astype(np.float32)

    latent_gt = smooth(32, 0.4)
    orient_gt = smooth(3, 0.1)
    cam_t_gt = np.asarray([0.0, 0.0, 3.0], np.float32) + smooth(3, 0.15)
    with torch.no_grad():
        out_gt = model(betas=torch.zeros((T, model.num_betas), device=dev),
                       global_orient=t(orient_gt),
                       body_pose=VP.decode(vp, t(latent_gt)))
    j_gt_cam = out_gt["joints"].cpu().numpy() + cam_t_gt[:, None, :]

    # 1. keypoint fit against the truth, per optimizer
    kcfg0 = KeypointFitConfig(num_iter=iters)
    valid = BODY25_FROM_SMPLX >= 0
    ids = np.where(valid, BODY25_FROM_SMPLX, 0)
    center = torch.tensor([kcfg0.image_size[0] / 2,
                           kcfg0.image_size[1] / 2], device=dev)

    def proj(j_cam):
        with torch.no_grad():
            return project(t(j_cam), kcfg0.focal_length,
                           center).cpu().numpy()

    j2d_gt = proj(j_gt_cam[:, ids])
    j2d_obs = j2d_gt + rng.randn(*j2d_gt.shape) * noise_px
    kp = np.concatenate(
        [j2d_obs, np.tile(valid.astype(np.float32)[None, :, None],
                          (T, 1, 1))], -1).astype(np.float32)

    def model_joints(body_75):
        """Camera-space joints at unit scale of packed [T, 75] params."""
        with torch.no_grad():
            d = P.split(t(body_75))
            o = model(betas=d["betas"], global_orient=d["global_orient"],
                      body_pose=VP.decode(vp, d["body_pose"]))
            return (o["joints"] + d["camera_translation"][:, None, :]
                    ).cpu().numpy()

    kp_results = {}
    for opt_name in ([] if skip_keypoint else optimizers):
        kcfg = KeypointFitConfig(
            num_iter=iters, optimizer=opt_name,
            allow_slow_perframe=(opt_name == "lbfgs_perframe"))
        params, _ = fit_keypoints(model, vp, kp, kcfg)
        j_fit_cam = model_joints(params)
        sel = np.unique(ids[valid])
        mpjpe_3d = float(np.linalg.norm(
            j_fit_cam[:, sel] - j_gt_cam[:, sel], axis=-1).mean())
        reproj_px = float(np.linalg.norm(
            proj(j_fit_cam[:, ids]) - j2d_gt, axis=-1)[:, valid].mean())
        kp_results[opt_name] = {"mpjpe_mm": round(mpjpe_3d * 1000, 2),
                                "reproj_px": round(reproj_px, 3)}
        print(f"[accuracy] keypoint fit ({opt_name}): 3D MPJPE "
              f"{mpjpe_3d * 1000:.1f} mm, 2D reproj {reproj_px:.2f} px "
              f"(obs noise {noise_px} px)", file=sys.stderr)
    if skip_keypoint:
        mpjpe_3d, reproj_px = float("nan"), float("nan")
    else:
        mpjpe_3d = kp_results[optimizers[0]]["mpjpe_mm"] / 1000.0
        reproj_px = kp_results[optimizers[0]]["reproj_px"]

    # 2. the clip solve pulls a noisy init toward the truth
    body_gt = np.concatenate(
        [np.zeros((T, 3), np.float32), orient_gt,
         np.zeros((T, model.num_betas), np.float32), latent_gt,
         np.zeros((T, 24), np.float32), cam_t_gt], -1)
    noise = rng.randn(T, 75).astype(np.float32) * body_noise
    noise[:, 6:16] = 0                           # betas stay clean
    body_noisy = body_gt + noise

    # the scene sits far below the body, so the robust contact energy
    # saturates (gradient ~ 0): the metric isolates what the temporal
    # terms do to white parameter noise on a smooth truth, which was
    # not generated standing on any scene
    g = 24
    xs, zs = np.meshgrid(np.linspace(-4, 4, g), np.linspace(-4, 4, g))
    scene = np.stack([xs.ravel(), np.full(g * g, -10.0), zs.ravel()],
                     1).astype(np.float32)
    segs = contact.synthetic_segments(model.num_verts, seed=3)
    vl = np.asarray(segs["L_Leg"], np.int32)
    vr = np.asarray(segs["R_Leg"], np.int32)
    window = 6 if T % 6 == 0 else T

    def solve(num_iter):
        solver = ClipSolver(
            model=model, vposer_params=vp, scene_verts=scene,
            contact_vids=np.concatenate([vl, vr]), contact_vids_left=vl,
            contact_vids_right=vr,
            config=ClipConfig(num_iter=num_iter, window=window, dct_num=3,
                              weights=LossWeights(rec=rec_weight)),
            device=dev)
        cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
        state, _ = solver.fit(body_noisy, cam, mode="local")
        with torch.no_grad():
            return model_joints(
                rotations.params_to_3d(state.body_6d).cpu().numpy())[:, :23]

    # metric: camera-space joints at unit scale from the 75-d params
    # (scale and camera_ext are free in the solve and the truth does not
    # pin them down)
    jw_gt = model_joints(body_gt)[:, :23]
    jw_noisy = model_joints(body_noisy)[:, :23]
    jw_solved = solve(clip_iters)
    err_before = float(np.linalg.norm(jw_noisy - jw_gt, axis=-1).mean())
    err_after = float(np.linalg.norm(jw_solved - jw_gt, axis=-1).mean())

    deep = None
    if deep_iters:
        # the same problem at a deeper schedule: under-convergence
        # against the objective's bias
        err_deep = float(np.linalg.norm(solve(deep_iters) - jw_gt,
                                        axis=-1).mean())
        deep = {"iters": deep_iters,
                "mpjpe_mm_after": round(err_deep * 1000, 2)}
        print(f"[accuracy] clip solve deep ({deep_iters} iters): "
              f"MPJPE-vs-truth {err_deep * 1000:.1f} mm", file=sys.stderr)

    # jitter: the mean second difference of the joint trajectories, what
    # the temporal terms exist to remove
    def jitter(j):
        return float(np.linalg.norm(j[2:] - 2 * j[1:-1] + j[:-2],
                                    axis=-1).mean())

    jit_gt, jit_noisy, jit_solved = (jitter(jw_gt), jitter(jw_noisy),
                                     jitter(jw_solved))
    print(f"[accuracy] clip solve: jitter (2nd-diff, mm) truth "
          f"{jit_gt * 1000:.2f} | noisy {jit_noisy * 1000:.2f} -> solved "
          f"{jit_solved * 1000:.2f}; MPJPE-vs-truth {err_before * 1000:.1f}"
          f" -> {err_after * 1000:.1f} mm", file=sys.stderr)

    out = {
        "frames": T,
        # flat keys are the first optimizer's
        "keypoint_optimizer": optimizers[0],
        "keypoint_fit": kp_results,
        "keypoint_fit_mpjpe_mm": round(mpjpe_3d * 1000, 2),
        "keypoint_fit_reproj_px": round(reproj_px, 3),
        "obs_noise_px": noise_px,
        "jitter_mm_truth": round(jit_gt * 1000, 3),
        "jitter_mm_noisy": round(jit_noisy * 1000, 3),
        "jitter_mm_solved": round(jit_solved * 1000, 3),
        "clip_solve_mpjpe_mm_before": round(err_before * 1000, 2),
        "clip_solve_mpjpe_mm_after": round(err_after * 1000, 2),
        "clip_iters": clip_iters,
        "rec_weight": rec_weight,
    }
    if deep is not None:
        out["clip_solve_deep"] = deep
    return out


def main(argv=None) -> int:
    from fpv4d_torch.cli.common import device_or_exit
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--num-verts", type=int, default=512)
    ap.add_argument("--noise-px", type=float, default=2.0,
                    help="pixel noise added to the 2D keypoints")
    ap.add_argument("--body-noise", type=float, default=0.05,
                    help="parameter noise for the clip-solve init")
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "lbfgs", "lbfgs_perframe", "both"])
    ap.add_argument("--deep-iters", type=int, default=0,
                    help="extra clip-solve row at this num_iter")
    ap.add_argument("--frontier-iters", type=int, default=0,
                    help="extra clip-solve-only row at this num_iter with "
                         "--frontier-rec")
    ap.add_argument("--frontier-rec", type=float, default=0.25)
    ap.add_argument("--sweep", action="store_true",
                    help="accuracy against iterations and rec weight: the "
                         "clip solve only, over iters x rec-weight")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    a = ap.parse_args(argv)
    dev = device_or_exit(a.device)
    if dev is None:
        return 1
    common = dict(frames=a.frames, num_verts=a.num_verts,
                  noise_px=a.noise_px, body_noise=a.body_noise,
                  iters=a.iters, device=dev)
    if a.sweep:
        rows = []
        for it in (60, 180, 400):
            for rec in (1.0, 0.5, 0.25):
                r = run(**common, clip_iters=it, rec_weight=rec,
                        skip_keypoint=True)
                rows.append({k: r[k] for k in
                             ("clip_iters", "rec_weight",
                              "clip_solve_mpjpe_mm_before",
                              "clip_solve_mpjpe_mm_after",
                              "jitter_mm_solved")})
                print(f"[sweep] iters={it} rec={rec}: "
                      f"{r['clip_solve_mpjpe_mm_before']} -> "
                      f"{r['clip_solve_mpjpe_mm_after']} mm (jitter "
                      f"{r['jitter_mm_solved']})", file=sys.stderr)
        print(json.dumps({"sweep": rows}))
        return 0
    out = run(**common, optimizer=a.optimizer, deep_iters=a.deep_iters)
    if a.frontier_iters:
        fr = run(**common, clip_iters=a.frontier_iters,
                 rec_weight=a.frontier_rec, skip_keypoint=True)
        out["frontier"] = {
            "clip_iters": a.frontier_iters, "rec_weight": a.frontier_rec,
            "mpjpe_mm_after": fr["clip_solve_mpjpe_mm_after"],
            "jitter_mm_solved": fr["jitter_mm_solved"]}
        print(f"[accuracy] frontier ({a.frontier_iters} iters, "
              f"rec={a.frontier_rec}): {fr['clip_solve_mpjpe_mm_after']} mm",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
