"""Multi-clip joint optimization CLI (port of fpv4d/cli/multiopt.py; the
same arguments, plus --nn-impl and --device).

    python -m fpv4d_torch.cli.multiopt CLIP_DIR [CLIP_DIR ...] \
        --out OUT_ROOT --mode global \
        [--scene-name meshed-poisson.ply] [--camera-name camerapose.txt] \
        [--frames T] [--mesh clips=R,frames=F] [--nn-impl grid|brute] \
        [--device cuda]

Each CLIP_DIR holds the reference's per-video layout: body_gen pkls, the
scene mesh or cloud and camerapose.txt. All clips are solved at once
(parallel/multi_clip.py): their variables batch over a leading clip
axis, their scenes are padded to a common size and their voxel grids
batched. Runs on the card (``--device cuda``, the default) and exits 1
when none is present; ``--device cpu`` runs the kernels' plain versions.

With a process group, the mesh lays R x F ranks out as clips x frames
(rank = c F + f): each rank solves its share of the clips' frames on its
own card (parallel/sharding.py), and rank 0 writes every clip's pkls.
The default mesh is the reference's, {"clips": min(ranks, clips)}; ranks
beyond the mesh solve nothing and wait for the others at the end:

    FPV4D_DISTRIBUTED=1 torchrun --nproc_per_node=N \
        -m fpv4d_torch.cli.multiopt CLIP_DIR ... --out OUT \
        --mesh clips=R,frames=F          # R x F = N at most
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_mesh(spec: str):
    axes = {}
    for part in spec.split(","):
        k, v = part.split("=")
        axes[k.strip()] = int(v)
    return axes


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("clips", nargs="+", help="clip directories")
    p.add_argument("--out", required=True)
    p.add_argument("--mode", default="global",
                   choices=["local", "global", "dct"])
    p.add_argument("--scene-name", default="meshed-poisson.ply")
    p.add_argument("--camera-name", default="camerapose.txt")
    p.add_argument("--frames", type=int, default=None,
                   help="truncate/align all clips to T frames")
    p.add_argument("--mesh", default=None,
                   help="mesh spec, e.g. clips=4 or clips=2,frames=2 "
                        "(default: min(ranks, clips) ranks on the clip "
                        "axis); F must divide --frames and leave each rank "
                        ">= 2 frames")
    p.add_argument("--model", default="./models")
    p.add_argument("--vposer", default="./vposer")
    p.add_argument("--segments", default="./body_segments")
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--contact-compact", type=int, default=0,
                   help="refresh-time contact candidate-table compaction "
                        "budget (0 = the full table)")
    p.add_argument("--sdf-json", default=None,
                   help="PROX scene-SDF metadata json (with --sdf-npy "
                        "activates the collision term; one SDF shared by "
                        "all clips)")
    p.add_argument("--sdf-npy", default=None,
                   help="PROX scene-SDF values npy")
    p.add_argument("--nn-impl", default="grid", choices=["grid", "brute"],
                   help="contact NN: voxel-grid candidate tables (K1) or "
                        "exact brute force over each clip's scene (K2)")
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

    import torch
    from fpv4d_torch.config import ClipConfig
    from fpv4d_torch.io import body_pkl, colmap
    from fpv4d_torch.parallel import sharding as SH
    from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
    from fpv4d_torch.solve.clip_solve import ClipSolver

    joined = torch.distributed.is_initialized()
    if SH.maybe_initialize_distributed(device=dev) and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    bodies, cams, scenes = [], [], []
    for clip in args.clips:
        bg = os.path.join(clip, "body_gen")
        body = body_pkl.load_clip(bg if os.path.isdir(bg) else clip)
        scene = common.load_scene(os.path.join(clip, args.scene_name))
        cam_path = os.path.join(clip, args.camera_name)
        T = body.shape[0]
        if os.path.isfile(cam_path):
            cam = colmap.camera_ext_from_file(cam_path)[:T]
            if cam.shape[0] < T:
                cam = np.concatenate(
                    [cam, np.tile(cam[-1:], (T - cam.shape[0], 1, 1))])
        else:
            cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
        bodies.append(body)
        cams.append(cam)
        scenes.append(scene)

    T = args.frames or min(b.shape[0] for b in bodies)
    bodies = np.stack([b[:T] for b in bodies])
    cams = np.stack([c[:T] for c in cams])
    lead = SH.rank() == 0
    if lead:
        print(f"[fpv4d_torch.multiopt] {len(args.clips)} clips x {T} "
              f"frames on {SH.world_size()} rank(s), {dev}",
              file=sys.stderr)

    model = common.load_model(args.model, device=dev)
    vp = common.load_vposer(args.vposer, device=dev)
    nv = model.num_verts
    vids_l = common.load_contacts(args.segments, ["L_Leg"], nv)
    vids_r = common.load_contacts(args.segments, ["R_Leg"], nv)

    sdf = None
    if args.sdf_json and args.sdf_npy:
        from fpv4d_torch.ops import sdf as SDF
        sdf = SDF.load_prox_sdf(args.sdf_json, args.sdf_npy, device=dev)

    window = 60 if T % 60 == 0 else T
    cfg = ClipConfig(num_iter=args.iters, window=window,
                     contact_compact=args.contact_compact)
    solver = ClipSolver(model=model, vposer_params=vp,
                        scene_verts=scenes[0],
                        contact_vids=np.concatenate([vids_l, vids_r]),
                        contact_vids_left=vids_l,
                        contact_vids_right=vids_r, config=cfg,
                        nn_impl=args.nn_impl, sdf=sdf, device=dev)
    axes = (parse_mesh(args.mesh) if args.mesh
            else {"clips": min(SH.world_size(), len(args.clips))})
    mesh = SH.make_mesh(axes)
    if mesh.member:
        mc = MultiClipSolver(solver=solver, mesh=mesh,
                             frame_axis="frames" if "frames" in axes
                             else None)
        state_b, hist = mc.fit(bodies, cams, pad_scenes(scenes),
                               mode=args.mode)
        results = mc.result_params(state_b)
    if lead:
        for phase, h in hist.items():
            print(f"[fpv4d_torch.multiopt] {phase}: mean loss "
                  f"{h[0].mean():.4f} -> {h[-1].mean():.4f}",
                  file=sys.stderr)
        for c, (body_out, scale, camera_ext) in enumerate(results):
            name = os.path.basename(os.path.normpath(args.clips[c]))
            paths = body_pkl.save_clip(os.path.join(args.out, name),
                                       body_out, scale, camera_ext)
            print(f"[fpv4d_torch.multiopt] {name}: {len(paths)} pkls "
                  f"(scale={scale:.4f})", file=sys.stderr)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        if not joined:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
