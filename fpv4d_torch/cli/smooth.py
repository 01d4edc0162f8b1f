"""Sequential per-frame smoothing CLI (port of fpv4d/cli/smooth.py; same
positional arguments and flags).

    python -m fpv4d_torch.cli.smooth GEN_PATH FIT_PATH \
        [--mode sequential|independent|motion] [--iters 50] [--lr 0.1] \
        [--motion-ckpt ./motion_model/epoch-30.ckp] [--device cuda]

Writes FIT_PATH/smoothed_body/%06d.pkl. Runs on the card (``--device
cuda``, the default) and exits non-zero when no card is present;
``--device cpu`` runs on the CPU. ``--mode motion`` reads the GRU
checkpoint with torch.load when the file exists, else (or when it
cannot be read, with a message) uses deterministic stand-in weights.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("gen_path", help="SMPLify-X output dir")
    p.add_argument("fit_path", help="output root (smoothed_body/ created)")
    p.add_argument("--mode", default="sequential",
                   choices=["sequential", "independent", "motion"])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--motion-ckpt", default="./motion_model/epoch-30.ckp")
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
    from fpv4d_torch.config import FrameFitConfig
    from fpv4d_torch.io import body_pkl
    from fpv4d_torch.solve import frame_fit

    body = body_pkl.load_clip(args.gen_path)
    print(f"[fpv4d_torch.smooth] {body.shape[0]} frames, mode={args.mode}",
          file=sys.stderr)
    cfg = FrameFitConfig(num_iter=args.iters, lr=args.lr)

    if args.mode == "independent":
        out = frame_fit.fit_independent(body, cfg, device=dev)
    elif args.mode == "motion":
        import torch
        from fpv4d_torch.models import motion_gru
        params = motion_gru.random_params(device=dev)
        if os.path.isfile(args.motion_ckpt):
            try:
                ckpt = torch.load(args.motion_ckpt, map_location="cpu",
                                  weights_only=False)
                params = motion_gru.params_from_torch_state_dict(
                    ckpt.get("model_state_dict", ckpt), device=dev)
                print(f"[fpv4d_torch.smooth] GRU ckpt: {args.motion_ckpt}",
                      file=sys.stderr)
            except Exception as e:
                print(f"[fpv4d_torch.smooth] GRU ckpt load failed ({e}) -> "
                      "random weights", file=sys.stderr)
        out = frame_fit.fit_sequential_motion(body, params, cfg, device=dev)
    else:
        out = frame_fit.fit_sequential(body, cfg, device=dev)

    paths = body_pkl.save_smoothed(args.fit_path, out)
    print(f"[fpv4d_torch.smooth] wrote {len(paths)} pkls under "
          f"{args.fit_path}/smoothed_body", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
