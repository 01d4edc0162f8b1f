"""Per-part profile of one world-view frame on the card.

    python -m fpv4d_torch.utils.profile_render [--steps 20]

The standard model (V=10,475, 20,946 faces) and scene (100,489 points)
at 1280x720, the standard problem's first frame with the camera 2.5 m
from the body (as ``chip_smoke.py`` phase 23 renders it), from the
first frame's camera. Measures each part of a frame in turn: the
chunked model forward (64 frames a call, per frame), the point splat
(scene, then 64 trajectory discs), the mesh fill, and the host PNG
encode (one device-to-host copy and zlib). For each it times
``--steps`` runs on the host clock around a synchronised window, then
profiles ``--steps`` more with torch.profiler (``profile_local.measure``).
Then the mesh fill again at several chunk caps (``raster.CHUNK``: the
face-rows plus outline pixels enumerated at once), each with its peak
device memory. Prints one JSON object: the card's name and power
limit, the frame's face-rows, pixel-face pairs and outline pixels
(counted from its geometry), and per part wall ms, device-busy ms and
busy share per run, launches per run and the kernels with the most
device time.

Exits non-zero without a CUDA device unless ``--device cpu`` is given
(a rehearsal of the control flow: no device numbers).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from fpv4d_torch.core.transforms import invert_rigid
from fpv4d_torch.models import params as P
from fpv4d_torch.utils.bench_problem import standard_problem
from fpv4d_torch.utils.profile_local import measure
from fpv4d_torch.vis import raster
from fpv4d_torch.vis import world_view as W
from fpv4d_torch.vis.frames import body_forward
from fpv4d_torch.vis.png import encode_png


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-verts", type=int, default=10475)
    ap.add_argument("--scene-pts", type=int, default=100_489)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("profile_render: no CUDA device available", file=sys.stderr)
        return 1

    prob = standard_problem(T=64, num_verts=args.num_verts,
                            scene_pts=args.scene_pts, num_iter=2,
                            num_iter_dct=2, device=dev)
    body = prob.body.copy()
    body[:, 74] += 2.5                 # the camera 2.5 m from the body
    frames = P.encapsulate_frames(body, 1.0, prob.cam)
    param, cam = frames[0], W.WORLD_CAMERA
    verts = body_forward(prob.model, prob.vp, frames)[0][0]
    trans = W.body_to_world(param, dev)
    view_inv = invert_rigid(torch.as_tensor(prob.cam[0], device=dev))
    gl = torch.tensor([1.0, -1.0, -1.0], device=dev)

    def to_cam(p):
        return (p @ view_inv[:3, :3].T + view_inv[:3, 3]) * gl

    verts_cam = to_cam(verts @ trans[:3, :3].T + trans[:3, 3])
    scene_cam = to_cam(torch.as_tensor(prob.scene, device=dev))
    traj_cam = to_cam(torch.as_tensor(prob.cam[:, :3, 3], device=dev))
    faces = torch.as_tensor(prob.model.faces, device=dev)
    img = raster.render_mesh(verts_cam, faces, cam)[0]
    img_u8 = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)

    def forward(n):
        for _ in range(n):
            body_forward(prob.model, prob.vp, frames)

    def points(n):
        for _ in range(n):
            im = raster.render_points(scene_cam, cam)
            raster.render_points(traj_cam, cam, colors=(1.0, 0.0, 0.0),
                                 radius=3, image=im)

    def mesh(n):
        for _ in range(n):
            raster.render_mesh(verts_cam, faces, cam)

    def encode(n):
        for _ in range(n):
            encode_png(img_u8)

    # the frame's work, counted from its geometry
    uv = cam.project(verts_cam)[0]
    p = torch.round(uv[faces]).long()
    face, y, x0, x1 = raster._fill_spans(p, cam.height, cam.width)
    ends = torch.stack([p.roll(1, dims=1), p], 2).reshape(-1, 2, 2)
    line, _ = raster._line_pixels(ends[:, 0], ends[:, 1], cam.height,
                                  cam.width)
    out = {"device": None, "power_limit": None, "steps": args.steps,
           "faces": int(faces.shape[0]), "face_rows": int(face.shape[0]),
           "pixel_face_pairs": int(torch.clamp(x1 - x0 + 1, min=0).sum()),
           "outline_pixels": int(line.shape[0]),
           "body_mask_px": int(np.count_nonzero(
               img.sum(-1).cpu().numpy()))}
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    # forward: one 64-frame call per run
    for name, fn in (("forward_64_frames", forward), ("points", points),
                     ("mesh", mesh), ("encode", encode)):
        out[name] = measure(fn, args.steps, dev)
    default = raster.CHUNK
    out["mesh_by_chunk"] = {}
    for cap in (default // 4, default, default * 4, default * 16):
        raster.CHUNK = cap
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            resident = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        rec = measure(mesh, args.steps, dev, top=0)
        if dev.type == "cuda":
            rec["peak_gib_above_resident"] = (
                torch.cuda.max_memory_allocated(dev) - resident) / 2**30
        out["mesh_by_chunk"][str(cap)] = rec
    raster.CHUNK = default
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
