"""Egocentric overlay rendering (port of fpv4d/vis/ego_overlay.py).

For each per-frame pkl: decode the VPoser latent, run the SMPL-X
forward, flip the mesh 180 degrees about X, place the pinhole camera at
camera_translation with its x negated, render 1280x720 on the model's
device, alpha-composite over the matching source frame images/%04d.jpg
when there is one, write <out>/%04d.png.

Variants:
  * source='smoothed'  reads smoothed_body/, writes smoothed_vis/
  * source='baseline'  reads the body_gen results, writes baseline_vis/
  * source='local'     multiplies verts and camera translation by the
    saved 'scale' and draws the 23 reprojected joints; writes local_vis/
"""
from __future__ import annotations

import glob
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from fpv4d_torch.io import body_pkl
from fpv4d_torch.vis import raster
from fpv4d_torch.vis.frames import (FORWARD_CHUNK, body_forward, count_mask,
                                    lap, save_png)


def _overlay(verts: torch.Tensor, joints: torch.Tensor, faces, param: Dict,
             camera: raster.Camera, apply_scale: bool,
             background, draw_joints: bool,
             stats: Optional[dict] = None) -> torch.Tensor:
    """One posed frame (vertices [V,3], joints [23,3]) -> composited
    overlay image [H,W,3] float on the vertices' device."""
    dev = verts.device
    t = time.perf_counter()
    scale = float(param.get("scale", 1.0)) if apply_scale else 1.0
    verts = verts * scale
    joints = joints * scale
    # 180-degree X flip: y, z negate
    flip = raster.rotation_x_180(dev)[:3, :3]
    verts = verts @ flip.T
    joints = joints @ flip.T
    # camera at camera_translation with x negated; the view transform is
    # the inverse of the camera pose, a subtraction
    cam_t = torch.as_tensor(np.asarray(param["camera_translation"],
                                       dtype=np.float32).reshape(3),
                            device=dev).clone()
    cam_t *= scale if apply_scale else 1.0
    cam_t[0] *= -1.0
    verts_cam = verts - cam_t
    joints_cam = joints - cam_t

    if background is None:
        background = torch.zeros((camera.height, camera.width, 3),
                                 dtype=torch.float32, device=dev)
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=dev)
    rgb, mask = raster.render_mesh(verts_cam, faces, camera)
    img = raster.composite(rgb, mask, background)
    t = lap(stats, "mesh", t, dev)
    count_mask(stats, mask)
    if draw_joints:
        uv, z = camera.project(joints_cam)
        img = raster.draw_circles(img, uv[z > 0])
        lap(stats, "points", t, dev)
    return img


def render_frame(model, vposer_params, param: Dict,
                 camera: Optional[raster.Camera] = None,
                 apply_scale: bool = False,
                 background=None,
                 draw_joints: bool = False) -> torch.Tensor:
    """One pkl dict -> composited overlay image [H,W,3] float on the
    model's device."""
    camera = camera or raster.Camera()
    verts, joints = body_forward(model, vposer_params, [param])
    return _overlay(verts[0], joints[0], model.faces, param, camera,
                    apply_scale, background, draw_joints)


def render_dir(fitting_dir: str, model, vposer_params,
               source: str = "smoothed",
               camera: Optional[raster.Camera] = None,
               limit: Optional[int] = None,
               stats: Optional[dict] = None) -> int:
    """Read pkls from fitting_dir, composite over the sibling images/,
    write PNGs to the sibling vis folder. Returns the number of frames
    written. stats: a dict that gains fenced seconds per part
    ('forward', 'mesh', 'points', 'encode') and each frame's body-mask
    pixels ('mask_pixels')."""
    camera = camera or raster.Camera()
    apply_scale = source == "local"
    if source == "baseline":
        pkls = body_pkl.list_body_gen(os.path.dirname(fitting_dir)
                                      or fitting_dir)
        out_name = "baseline_vis"
    else:
        pkls = sorted(glob.glob(os.path.join(fitting_dir, "*.pkl")))
        out_name = "smoothed_vis" if source == "smoothed" else "local_vis"

    base = os.path.dirname(os.path.abspath(fitting_dir))
    img_dir = os.path.join(base, "images")
    out_dir = os.path.join(base, out_name)
    os.makedirs(out_dir, exist_ok=True)

    dev = model.v_template.device
    faces = torch.as_tensor(model.faces, device=dev)
    pkls = pkls[:limit]
    for s in range(0, len(pkls), FORWARD_CHUNK):
        params = [body_pkl.load_frame(p) for p in pkls[s:s + FORWARD_CHUNK]]
        t = time.perf_counter()
        verts, joints = body_forward(model, vposer_params, params)
        lap(stats, "forward", t, dev)
        for j, param in enumerate(params):
            i = s + j
            bg = _load_background(img_dir, i, camera)
            img = _overlay(verts[j], joints[j], faces, param, camera,
                           apply_scale, bg, apply_scale, stats)
            t = time.perf_counter()
            save_png(os.path.join(out_dir, f"{i:04d}.png"), img)
            lap(stats, "encode", t, dev)
    return len(pkls)


def _load_background(img_dir: str, idx: int,
                     camera: Optional[raster.Camera]
                     ) -> Optional[torch.Tensor]:
    """The source frame behind frame idx as float [H,W,3] on the CPU, or
    None when there is none. Reading a JPG or PNG needs OpenCV: an
    existing frame without cv2 raises ImportError."""
    cam = camera or raster.Camera()
    for pattern in (f"{idx:04d}.jpg", f"{idx:06d}.jpg", f"{idx:04d}.png",
                    f"{idx:06d}.png"):
        path = os.path.join(img_dir, pattern)
        if os.path.exists(path):
            try:
                import cv2
            except ImportError as e:
                raise ImportError(
                    f"reading the background frame {path} needs OpenCV "
                    "(cv2), which is not installed") from e
            img = cv2.imread(path)
            if img is not None:
                img = cv2.resize(img, (cam.width, cam.height))
                return torch.from_numpy(np.ascontiguousarray(
                    img[:, :, ::-1])).float() / 255.0
    return None
