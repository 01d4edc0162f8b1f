"""Clip-level joint optimization CLI, the main entry point (port of
fpv4d/cli/globalopt.py; same positional arguments and flags).

    python -m fpv4d_torch.cli.globalopt BODY_PATH FIT_PATH MODE \
        [--scene meshed-poisson.ply] [--camera camerapose.txt] \
        [--model ./models] [--vposer ./vposer] \
        [--segments ./body_segments] [--iters 500] \
        [--nn-impl grid|brute] [--device cuda]

Runs on the card (``--device cuda``, the default) and exits non-zero
when no card is present; ``--device cpu`` runs the kernels' plain
versions on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("body_path", help="SMPLify-X output dir (body_gen)")
    p.add_argument("fit_path", help="output dir for per-frame pkls")
    p.add_argument("mode", choices=["local", "global", "dct"],
                   help="smoothing-term mode")
    p.add_argument("--scene", default=None,
                   help="scene mesh/cloud (.ply or .xyz)")
    p.add_argument("--camera", default=None, help="camerapose.txt")
    p.add_argument("--model", default="./models")
    p.add_argument("--vposer", default="./vposer")
    p.add_argument("--segments", default="./body_segments")
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--nn-impl", default="grid", choices=["grid", "brute"],
                   help="contact NN: voxel-grid candidate tables (K1) or "
                        "exact brute force over the scene (K2)")
    p.add_argument("--cand-impl", default="auto", choices=["auto"],
                   help="per-step candidate NN: the CUDA kernel on the "
                        "card, its plain version on the CPU")
    p.add_argument("--skate-subset", type=int, default=0,
                   help="stratified vertex count for the anti-skate "
                        "smoothing estimator (0 = the full mesh)")
    p.add_argument("--skate-body-only", action="store_true",
                   help="restrict the skate sample to body-subtree "
                        "vertices; needs --skate-subset > 0")
    p.add_argument("--contact-compact", type=int, default=0,
                   help="refresh-time candidate-table compaction budget "
                        "(0 = the full table)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write the solver state after each phase "
                        "(torch.save files)")
    p.add_argument("--sdf-json", default=None,
                   help="PROX scene-SDF metadata json (with --sdf-npy "
                        "activates the collision term)")
    p.add_argument("--sdf-npy", default=None,
                   help="PROX scene-SDF values npy")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback to the "
                        "CPU)")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fpv4d_torch.cli import common
    dev = common.device_or_exit(args.device)
    if dev is None:
        return 1

    from fpv4d_torch.config import ClipConfig
    from fpv4d_torch.io import body_pkl, colmap
    from fpv4d_torch.solve.clip_solve import ClipSolver

    body = body_pkl.load_clip(args.body_path)
    T = body.shape[0]
    print(f"[fpv4d_torch.globalopt] {T} frames from {args.body_path}",
          file=sys.stderr)

    model = common.load_model(args.model, device=dev)
    vp = common.load_vposer(args.vposer, device=dev)
    scene = common.load_scene(args.scene)

    if args.camera and os.path.isfile(args.camera):
        cam = colmap.camera_ext_from_file(args.camera)[:T]
        if cam.shape[0] < T:
            pad = np.tile(cam[-1:], (T - cam.shape[0], 1, 1))
            cam = np.concatenate([cam, pad])
    else:
        print("[fpv4d_torch.globalopt] no camerapose.txt -> identity "
              "camera init", file=sys.stderr)
        cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))

    nv = model.num_verts
    vids_l = common.load_contacts(args.segments, ["L_Leg"], nv)
    vids_r = common.load_contacts(args.segments, ["R_Leg"], nv)

    sdf = None
    if args.sdf_json and args.sdf_npy:
        from fpv4d_torch.ops import sdf as SDF
        sdf = SDF.load_prox_sdf(args.sdf_json, args.sdf_npy, device=dev)
        print("[fpv4d_torch.globalopt] scene SDF loaded -> collision term "
              "active", file=sys.stderr)

    window = 60 if T % 60 == 0 else T
    cfg = ClipConfig(num_iter=args.iters, lr=args.lr, window=window,
                     skate_subset=args.skate_subset,
                     skate_body_only=args.skate_body_only,
                     contact_compact=args.contact_compact,
                     cand_impl=args.cand_impl)
    solver = ClipSolver(model=model, vposer_params=vp, scene_verts=scene,
                        contact_vids=np.concatenate([vids_l, vids_r]),
                        contact_vids_left=vids_l,
                        contact_vids_right=vids_r, config=cfg,
                        nn_impl=args.nn_impl, sdf=sdf, device=dev)
    state, _ = solver.fit(body, cam, mode=args.mode, verbose=True,
                          checkpoint_dir=args.checkpoint_dir)
    body_out, scale, camera_ext = solver.result_params(state)
    paths = body_pkl.save_clip(args.fit_path, body_out, scale, camera_ext)
    print(f"[fpv4d_torch.globalopt] wrote {len(paths)} pkls to "
          f"{args.fit_path} (scale={scale:.4f})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
