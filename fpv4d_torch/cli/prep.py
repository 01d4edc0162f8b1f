"""Data-prep CLI (port of fpv4d/cli/prep.py; same subcommands,
arguments and outputs). Host-only: no subcommand uses the card.

  dump         video -> frames (ffmpeg, several videos at once)
  split        frames -> 300-frame clips
  pack         frames -> video for OpenPose (OpenCV)
  recode       fps recode (ffmpeg)
  openpose-cmd print the OpenPose command line
  rename       %06d_keypoints.json renaming
  filter       keep one person per JSON
  masks        human-bbox masks for COLMAP (grey PNGs, no OpenCV)
  pairs        temporal match-pair list
  campose      images.txt -> camerapose.txt
  cloud        points3D.txt -> xyz
  flatten      smplifyx results -> body_gen/

dump, recode and pack exit 1, with a message that names ffmpeg or cv2,
when the tool is missing.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump")
    d.add_argument("videos", nargs="+")
    d.add_argument("--out", required=True)
    d.add_argument("--fps", type=int, default=30)
    d.add_argument("--width", type=int, default=1280)
    d.add_argument("--height", type=int, default=720)
    d.add_argument("--jobs", type=int, default=4)

    s = sub.add_parser("split")
    s.add_argument("images_dir")
    s.add_argument("--out", required=True)
    s.add_argument("--name", required=True)
    s.add_argument("--clip-len", type=int, default=300)

    pk = sub.add_parser("pack")
    pk.add_argument("images_dir")
    pk.add_argument("--out", required=True)
    pk.add_argument("--fps", type=int, default=30)

    r = sub.add_parser("recode")
    r.add_argument("video")
    r.add_argument("--out", required=True)
    r.add_argument("--fps", type=int, default=30)

    oc = sub.add_parser("openpose-cmd")
    oc.add_argument("video")
    oc.add_argument("--binary", default="./build/examples/openpose/"
                    "openpose.bin")
    oc.add_argument("--json-out", required=True)
    oc.add_argument("--video-out", default=None)

    rn = sub.add_parser("rename")
    rn.add_argument("json_dir")
    rn.add_argument("--out", default=None)

    fl = sub.add_parser("filter")
    fl.add_argument("json_dir")
    fl.add_argument("--out", required=True)
    fl.add_argument("--first", action="store_true",
                    help="keep people[0] like the reference (default: "
                    "most confident)")

    m = sub.add_parser("masks")
    m.add_argument("json_dir")
    m.add_argument("--out", required=True)
    m.add_argument("--width", type=int, default=1280)
    m.add_argument("--height", type=int, default=720)

    pr = sub.add_parser("pairs")
    pr.add_argument("images_dir")
    pr.add_argument("--out", required=True)

    cp = sub.add_parser("campose")
    cp.add_argument("images_txt")
    cp.add_argument("--out", required=True)

    cl = sub.add_parser("cloud")
    cl.add_argument("points3d_txt")
    cl.add_argument("--out", required=True)

    ft = sub.add_parser("flatten")
    ft.add_argument("results_root")
    ft.add_argument("--out", required=True)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from fpv4d_torch.io import video, keypoints, colmap, body_pkl

    if args.cmd == "dump":
        res = video.extract_frames_parallel(
            args.videos, args.out, n_jobs=args.jobs, fps=args.fps,
            size=(args.width, args.height))
        bad = [r for r in res if not r[0]]
        for ok, err in bad:
            print(f"[fpv4d_torch.prep] ffmpeg failed: {err}", file=sys.stderr)
        return 1 if bad else 0

    if args.cmd == "split":
        clips = video.split_frames(args.images_dir, args.out, args.name,
                                   args.clip_len)
        print(f"[fpv4d_torch.prep] {len(clips)} clips", file=sys.stderr)
        return 0

    if args.cmd == "pack":
        try:
            ok, err = video.pack_frames_to_video(args.images_dir, args.out,
                                                 fps=args.fps)
        except ImportError as e:
            ok, err = False, str(e)
        if not ok:
            print(f"[fpv4d_torch.prep] pack failed: {err}", file=sys.stderr)
        return 0 if ok else 1

    if args.cmd == "recode":
        ok, err = video.recode_fps(args.video, args.out, args.fps)
        if not ok:
            print(f"[fpv4d_torch.prep] ffmpeg failed: {err}",
                  file=sys.stderr)
        return 0 if ok else 1

    if args.cmd == "openpose-cmd":
        cmd = video.openpose_command(args.binary, args.video,
                                     args.json_out,
                                     out_video=args.video_out)
        print(" ".join(cmd))
        return 0

    if args.cmd == "rename":
        out = keypoints.rename_for_smplifyx(args.json_dir, args.out)
        print(f"[fpv4d_torch.prep] renamed {len(out)} JSONs", file=sys.stderr)
        return 0

    if args.cmd == "filter":
        os.makedirs(args.out, exist_ok=True)
        files = sorted(glob.glob(os.path.join(args.json_dir, "*.json")))
        for f in files:
            keypoints.filter_single_person(
                f, os.path.join(args.out, os.path.basename(f)),
                best=not args.first)
        print(f"[fpv4d_torch.prep] filtered {len(files)} JSONs",
              file=sys.stderr)
        return 0

    if args.cmd == "masks":
        import numpy as np
        from fpv4d_torch.vis.png import encode_png
        os.makedirs(args.out, exist_ok=True)
        files = sorted(glob.glob(os.path.join(args.json_dir, "*.json")))
        for f in files:
            kp = keypoints.read_keypoints(f)
            pose = kp["pose"] if kp else np.zeros((25, 3), np.float32)
            mask = keypoints.human_bbox_mask(pose, args.height,
                                             args.width)
            name = os.path.splitext(os.path.basename(f))[0] + ".png"
            with open(os.path.join(args.out, name), "wb") as fh:
                fh.write(encode_png(mask))
        print(f"[fpv4d_torch.prep] {len(files)} masks", file=sys.stderr)
        return 0

    if args.cmd == "pairs":
        names = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(args.images_dir, "*.jpg")))
        n = colmap.write_match_pairs(names, args.out)
        print(f"[fpv4d_torch.prep] {n} pairs", file=sys.stderr)
        return 0

    if args.cmd == "campose":
        n = colmap.images_txt_to_camerapose(args.images_txt, args.out)
        print(f"[fpv4d_torch.prep] {n} poses", file=sys.stderr)
        return 0

    if args.cmd == "cloud":
        pts = colmap.read_points3d(args.points3d_txt)
        colmap.write_xyz(pts, args.out)
        print(f"[fpv4d_torch.prep] {len(pts)} points", file=sys.stderr)
        return 0

    if args.cmd == "flatten":
        n = body_pkl.flatten_smplifyx_results(args.results_root, args.out)
        print(f"[fpv4d_torch.prep] {n} pkls", file=sys.stderr)
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
