"""COLMAP text-format readers the clip solve needs (port of the
camerapose and xyz parts of fpv4d/io/colmap.py)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fpv4d_torch.core.transforms import colmap_pose_to_world_from_cam


def read_camerapose(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """camerapose.txt -> (qvec [T,4], tvec [T,3]). Line format:
    ``<name> qw qx qy qz tx ty tz`` (world-to-camera, COLMAP's
    images.txt convention); shorter lines are skipped."""
    qs, ts = [], []
    with open(path) as f:
        for line in f:
            items = line.strip().split()
            if len(items) < 8:
                continue
            vals = [float(v) for v in items[1:8]]
            qs.append(vals[:4])
            ts.append(vals[4:7])
    return (np.asarray(qs, dtype=np.float32),
            np.asarray(ts, dtype=np.float32))


def camera_ext_from_file(path: str) -> np.ndarray:
    """camerapose.txt -> [T,4,4] world-from-camera matrices (the
    inverted extrinsics the clip solver seeds camera_ext with),
    computed in f32 on the CPU."""
    q, t = read_camerapose(path)
    return colmap_pose_to_world_from_cam(torch.from_numpy(q),
                                         torch.from_numpy(t)).numpy()


def read_xyz(path: str) -> np.ndarray:
    """Whitespace .xyz point file -> [N,3] f32."""
    return np.loadtxt(path, dtype=np.float32).reshape(-1, 3)
