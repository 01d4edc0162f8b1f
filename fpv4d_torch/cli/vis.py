"""Visualization CLI (port of fpv4d/cli/vis.py; same subcommands and
arguments, plus --device).

  ego smoothed   smoothed_body overlay
  ego baseline   raw body_gen overlay
  ego local      scale-aware overlay + joints
  world          fixed first-frame viewpoint (--follow: camera-following,
                 --orbit: turntable)
  interactive    live viewer (browser-driven HTTP event loop)
  pack           frames -> video (needs OpenCV)

    V="python -m fpv4d_torch.cli.vis"
    $V ego FITTING_DIR [--source smoothed|baseline|local]
    $V world FITTING_DIR --scene scene.ply --out render0
    $V interactive FITTING_DIR --scene scene.ply --port 8089
    $V pack VIS_DIR [--out out.mp4]

ego, world and interactive render on the card (``--device cuda``, the
default) and exit 1 when no card is present; ``--device cpu`` renders
on the CPU. pack exits 1 when it fails, OpenCV missing included.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device (default cuda; no fallback "
                                 "to the CPU)")

    ego = sub.add_parser("ego", help="egocentric overlay")
    ego.add_argument("fitting_dir")
    ego.add_argument("--source", default="smoothed",
                     choices=["smoothed", "baseline", "local"])
    ego.add_argument("--model", default="./models")
    ego.add_argument("--vposer", default="./vposer")
    ego.add_argument("--limit", type=int, default=None)
    device(ego)

    world = sub.add_parser("world", help="world-coordinate render")
    world.add_argument("fitting_dir")
    world.add_argument("--scene", required=True)
    world.add_argument("--out", default="render0")
    world.add_argument("--follow", action="store_true",
                       help="camera-following viewpoint")
    world.add_argument("--orbit", action="store_true",
                       help="turntable sweep around the scene (the "
                            "windowed viewer's orbit mode, offline)")
    world.add_argument("--orbit-turns", type=float, default=1.0,
                       help="revolutions over the clip with --orbit")
    world.add_argument("--model", default="./models")
    world.add_argument("--vposer", default="./vposer")
    world.add_argument("--limit", type=int, default=None)
    device(world)

    ia = sub.add_parser("interactive",
                        help="live viewer (HTTP event loop)")
    ia.add_argument("fitting_dir")
    ia.add_argument("--scene", required=True)
    ia.add_argument("--port", type=int, default=8089)
    ia.add_argument("--host", default="127.0.0.1")
    ia.add_argument("--model", default="./models")
    ia.add_argument("--vposer", default="./vposer")
    ia.add_argument("--limit", type=int, default=None)
    device(ia)

    pack = sub.add_parser("pack", help="frames -> video")
    pack.add_argument("vis_dir")
    pack.add_argument("--out", default=None)
    pack.add_argument("--fps", type=int, default=30)
    return p


def main(argv=None) -> int:
    from fpv4d_torch.cli import common
    args = build_parser().parse_args(argv)

    if args.cmd == "pack":
        from fpv4d_torch.vis.export import pack_vis_outputs
        try:
            ok, err = pack_vis_outputs(args.vis_dir, args.out, args.fps)
        except ImportError as e:
            ok, err = False, str(e)
        if not ok:
            print(f"[fpv4d_torch.vis] pack failed: {err}", file=sys.stderr)
            return 1
        return 0

    dev = common.device_or_exit(args.device)
    if dev is None:
        return 1
    model = common.load_model(args.model, device=dev)
    vp = common.load_vposer(args.vposer, device=dev)

    if args.cmd == "ego":
        from fpv4d_torch.vis.ego_overlay import render_dir
        n = render_dir(args.fitting_dir, model, vp, source=args.source,
                       limit=args.limit)
        print(f"[fpv4d_torch.vis] rendered {n} overlay frames",
              file=sys.stderr)
        return 0

    if args.cmd == "world":
        from fpv4d_torch.vis.world_view import render_dir
        scene = common.load_scene(args.scene)
        n = render_dir(args.fitting_dir, model, vp, scene, args.out,
                       follow=args.follow, orbit=args.orbit,
                       orbit_turns=args.orbit_turns, limit=args.limit)
        print(f"[fpv4d_torch.vis] rendered {n} world frames to {args.out}",
              file=sys.stderr)
        return 0

    if args.cmd == "interactive":
        from fpv4d_torch.vis.interactive import (InteractiveViewer,
                                                 make_server)
        scene = common.load_scene(args.scene)
        viewer = InteractiveViewer(args.fitting_dir, model, vp, scene,
                                   limit=args.limit)
        srv = make_server(viewer, port=args.port, host=args.host)
        print(f"[fpv4d_torch.vis] interactive viewer: "
              f"http://{args.host}:{srv.server_address[1]}/ "
              f"({viewer.num_frames} frames; ctrl-c to stop)",
              file=sys.stderr)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
