"""World-coordinate rendering (port of fpv4d/vis/world_view.py).

Renders, per frame, on the model's device: the scene cloud, the body
mesh transformed into world coordinates by camera_ext @ (I |
scale*camera_translation), and red trajectory discs at the camera
centers. Viewpoint: the first frame's camera pose, a follow-cam (each
frame's camera), or a turntable orbit. Images are written as
<out_dir>/img_%03d.png.
"""
from __future__ import annotations

import glob
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from fpv4d_torch.core.transforms import invert_rigid
from fpv4d_torch.io import body_pkl
from fpv4d_torch.vis import raster
from fpv4d_torch.vis.frames import (FORWARD_CHUNK, body_forward, count_mask,
                                    lap, save_png)

# intrinsics of the world view
WORLD_CAMERA = raster.Camera(fx=692.0, fy=692.0, cx=639.5, cy=359.5)
# COLMAP/OpenCV camera axes (x right, y down, z forward) -> the
# rasterizer's GL axes (y up, -z forward)
_CV_TO_GL = (1.0, -1.0, -1.0)


def _f32(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def body_to_world(param: Dict, device=None) -> torch.Tensor:
    """camera_ext @ (I | scale * camera_translation) [4, 4]: the world
    placement of a saved frame."""
    scale = float(param.get("scale", 1.0))
    ct = _f32(param["camera_translation"], device).reshape(3)
    pivot = torch.eye(4, dtype=torch.float32, device=device)
    pivot[:3, 3] = ct * scale
    cam_ext = _f32(param.get("camera_ext", np.eye(4)), device)
    return cam_ext @ pivot


def camera_center(cam_ext: torch.Tensor) -> torch.Tensor:
    """World position of the camera from its world-from-camera matrix."""
    return cam_ext[:3, 3]


def _to_cam(p: torch.Tensor, view_inv: torch.Tensor) -> torch.Tensor:
    gl = torch.tensor(_CV_TO_GL, dtype=torch.float32, device=p.device)
    return (p @ view_inv[:3, :3].T + view_inv[:3, 3]) * gl


def _world(verts: torch.Tensor, faces, param: Dict,
           scene_pts: torch.Tensor, view: torch.Tensor,
           trajectory: Optional[torch.Tensor], camera: raster.Camera,
           stats: Optional[dict] = None) -> torch.Tensor:
    """One posed frame (vertices [V,3]) -> world-view image [H,W,3]."""
    dev = verts.device
    t = time.perf_counter()
    verts = verts * float(param.get("scale", 1.0))
    trans = body_to_world(param, dev)
    verts_w = verts @ trans[:3, :3].T + trans[:3, 3]
    # into the view camera's frame, then COLMAP -> GL axes (else
    # everything sits behind the camera and renders black)
    view_inv = invert_rigid(torch.as_tensor(view, dtype=torch.float32,
                                            device=dev))
    img = raster.render_points(_to_cam(scene_pts, view_inv), camera)
    if trajectory is not None and len(trajectory):
        img = raster.render_points(_to_cam(trajectory, view_inv), camera,
                                   colors=(1.0, 0.0, 0.0), radius=3,
                                   image=img)
    t = lap(stats, "points", t, dev)
    rgb, mask = raster.render_mesh(_to_cam(verts_w, view_inv), faces,
                                   camera, base_color=(0.95, 0.8, 0.7))
    img = raster.composite(rgb, mask, img)
    lap(stats, "mesh", t, dev)
    count_mask(stats, mask)
    return img


def render_frame(model, vposer_params, param: Dict,
                 scene_pts, view,
                 trajectory=None,
                 camera: raster.Camera = WORLD_CAMERA) -> torch.Tensor:
    """One world-view frame on the model's device. view: [4,4]
    world-from-camera of the viewpoint; scene_pts [M,3]; trajectory
    [K,3] camera centers so far (drawn as red discs)."""
    dev = model.v_template.device
    verts, _ = body_forward(model, vposer_params, [param])
    traj = None if trajectory is None else _f32(trajectory, dev)
    return _world(verts[0], model.faces, param, _f32(scene_pts, dev),
                  view, traj, camera)


def orbit_view(center, radius: float, azimuth: float,
               elevation: float = 0.35) -> torch.Tensor:
    """World-from-camera matrix (COLMAP convention, +Z forward) of a
    turntable camera at `azimuth` radians around `center`, looking at
    it. The world is y-up (the synthetic scenes put the floor at
    y = -1; only the camera axes follow COLMAP's y-down convention), so
    a positive `elevation` raises the eye above the center."""
    center = torch.as_tensor(center, dtype=torch.float32)
    dev = center.device
    eye = center + radius * torch.tensor(
        [math.cos(azimuth) * math.cos(elevation), math.sin(elevation),
         math.sin(azimuth) * math.cos(elevation)], dtype=torch.float32,
        device=dev)
    fwd = center - eye
    fwd = fwd / (torch.linalg.vector_norm(fwd) + 1e-9)    # +Z forward
    up = torch.tensor([0.0, -1.0, 0.0], device=dev)       # COLMAP y down
    right = torch.linalg.cross(up, fwd)
    right = right / (torch.linalg.vector_norm(right) + 1e-9)
    down = torch.linalg.cross(fwd, right)
    view = torch.eye(4, dtype=torch.float32, device=dev)
    view[:3, 0], view[:3, 1], view[:3, 2] = right, down, fwd
    view[:3, 3] = eye
    return view


def render_dir(fitting_dir: str, model, vposer_params,
               scene_pts, out_dir: str,
               follow: bool = False, orbit: bool = False,
               orbit_turns: float = 1.0,
               limit: Optional[int] = None,
               stats: Optional[dict] = None) -> int:
    """Render all frames of a smoothed_body directory.

    follow=False: fixed viewpoint at the first frame's camera pose;
    follow=True: the viewpoint tracks each frame's camera; orbit=True: a
    turntable sweep of `orbit_turns` revolutions around the body
    trajectory over the clip. Writes <out_dir>/img_%03d.png and returns
    the frame count. stats: a dict that gains fenced seconds per part
    ('forward', 'points', 'mesh', 'encode') and each frame's body-mask
    pixels ('mask_pixels')."""
    pkls = sorted(glob.glob(os.path.join(fitting_dir, "*.pkl")))[:limit]
    os.makedirs(out_dir, exist_ok=True)
    dev = model.v_template.device
    params = [body_pkl.load_frame(p) for p in pkls]
    if not params:
        return 0
    cams = _f32(np.stack([np.asarray(p.get("camera_ext", np.eye(4)),
                                     np.float32) for p in params]), dev)
    trajectory = cams[:, :3, 3]                 # camera_center per frame
    if orbit:
        # around the body trajectory's centroid, at a radius covering
        # its extent (plus a margin for the body)
        centers = torch.stack([body_to_world(p, dev)[:3, 3]
                               for p in params])
        center = centers.mean(0)
        radius = float(max(2.5, 1.8 * float(torch.linalg.vector_norm(
            centers - center, dim=1).max())))
    scene = _f32(scene_pts, dev)
    faces = torch.as_tensor(model.faces, device=dev)
    n = len(params)
    for s in range(0, n, FORWARD_CHUNK):
        chunk = params[s:s + FORWARD_CHUNK]
        t = time.perf_counter()
        verts, _ = body_forward(model, vposer_params, chunk)
        lap(stats, "forward", t, dev)
        for j, param in enumerate(chunk):
            i = s + j
            if orbit:
                view = orbit_view(center, radius,
                                  2.0 * np.pi * orbit_turns * i / n)
            else:
                view = cams[i] if follow else cams[0]
            img = _world(verts[j], faces, param, scene, view,
                         trajectory[:i + 1], WORLD_CAMERA, stats)
            t = time.perf_counter()
            save_png(os.path.join(out_dir, f"img_{i:03d}.png"), img)
            lap(stats, "encode", t, dev)
    return n
