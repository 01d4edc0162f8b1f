"""Fit-from-keypoints CLI, the SMPLify-X stage (port of fpv4d/cli/fit.py;
same positional arguments and flags).

    python -m fpv4d_torch.cli.fit KEYPOINTS_DIR OUT_DIR \
        [--focal 694] [--width 1280 --height 720] [--iters 120] \
        [--optimizer adam|lbfgs|lbfgs_perframe] [--device cuda]

Runs on the card (``--device cuda``, the default) and exits non-zero
when no card is present; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("keypoints_dir", help="OpenPose JSON folder")
    p.add_argument("out_dir", help="output dir for body_gen pkls")
    p.add_argument("--focal", type=float, default=694.0)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--iters", type=int, default=120)
    p.add_argument("--model", default="./models")
    p.add_argument("--vposer", default="./vposer")
    p.add_argument("--no-hands", action="store_true",
                   help="ignore hand keypoints even when present")
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "lbfgs", "lbfgs_perframe"],
                   help="per-stage optimizer: adam (default), joint L-BFGS "
                        "over the clip (the smplifyx family; typically "
                        "needs ~1/4 the iters), or per-frame L-BFGS")
    p.add_argument("--allow-slow-perframe", action="store_true",
                   help="accepted for the reference's signature; the port "
                        "never refuses lbfgs_perframe")
    p.add_argument("--no-face", action="store_true",
                   help="ignore face keypoints even when present "
                        "(face fitting needs a model with landmark "
                        "tables: jaw pose + expression from the 70 "
                        "OpenPose face points)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no fallback to the "
                        "CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fpv4d_torch.cli import common
    dev = common.device_or_exit(args.device)
    if dev is None:
        return 1
    from fpv4d_torch.config import KeypointFitConfig
    from fpv4d_torch.io import body_pkl, keypoints
    from fpv4d_torch.solve.keypoint_fit import fit_keypoints

    full = keypoints.load_clip_keypoints_full(args.keypoints_dir)
    kp = full["pose"]
    if kp.shape[0] == 0:
        print(f"[fpv4d_torch.fit] no keypoint JSONs in {args.keypoints_dir}",
              file=sys.stderr)
        return 1
    hands = {}
    if not args.no_hands:
        for side in ("hand_left", "hand_right"):
            if full[side].size and full[side][..., 2].max() > 0:
                hands[side] = full[side]
    face = None
    if not args.no_face and full["face"].size \
            and full["face"][..., 2].max() > 0:
        face = full["face"]
    print(f"[fpv4d_torch.fit] {kp.shape[0]} frames of keypoints"
          + (f" (+{len(hands)} hand streams)" if hands else "")
          + (" (+face)" if face is not None else ""), file=sys.stderr)

    model = common.load_model(args.model, device=dev)
    vp = common.load_vposer(args.vposer, device=dev)
    cfg = KeypointFitConfig(focal_length=args.focal,
                            image_size=(args.width, args.height),
                            num_iter=args.iters, optimizer=args.optimizer,
                            allow_slow_perframe=args.allow_slow_perframe)
    params, hist = fit_keypoints(model, vp, kp, cfg,
                                 hand_left=hands.get("hand_left"),
                                 hand_right=hands.get("hand_right"),
                                 face=face, device=dev)
    for name in ("camera", "body", "all"):
        if name in hist:
            h = hist[name]
            print(f"[fpv4d_torch.fit] stage {name}: {h[0]:.2f} -> "
                  f"{h[-1]:.2f}", file=sys.stderr)
    extra = None
    if face is not None:
        extra = {"jaw_pose": hist["jaw"], "expression": hist["expression"]}
    paths = body_pkl.save_clip(args.out_dir, params, extra=extra)
    print(f"[fpv4d_torch.fit] wrote {len(paths)} pkls to {args.out_dir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
