"""COLMAP text-format parsers and converters (port of
fpv4d/io/colmap.py).

Covers:
  * ``camerapose.txt`` (one line per frame: name qw qx qy qz tx ty tz)
    -> batched world-from-camera [T,4,4];
  * ``images.txt`` -> ``camerapose.txt``;
  * ``points3D.txt`` -> xyz point array / .xyz file;
  * the match-pair list for COLMAP's matcher with the temporal window
    pattern.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

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


def images_txt_to_camerapose(images_txt: str, out_path: str) -> int:
    """COLMAP sparse/images.txt -> camerapose.txt, ordered by image
    name: comment lines skipped, the pose lines (IMAGE_ID qw qx qy qz
    tx ty tz CAMERA_ID NAME) kept, the 2D-point lines between them
    dropped. Returns the number of poses written."""
    entries = []
    with open(images_txt) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for ln in lines:
        if ln.startswith("#"):
            continue
        items = ln.split()
        if len(items) == 10 and _is_float(items[1]):
            entries.append((items[9], items[1:8]))
    entries.sort(key=lambda e: e[0])
    with open(out_path, "w") as f:
        for name, vals in entries:
            f.write(name + " " + " ".join(vals) + "\n")
    return len(entries)


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def read_points3d(points3d_txt: str) -> np.ndarray:
    """COLMAP points3D.txt -> [N,3] float32 xyz (columns 1:4 of each
    non-comment line)."""
    pts = []
    with open(points3d_txt) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            items = ln.split()
            pts.append([float(items[1]), float(items[2]),
                        float(items[3])])
    return np.asarray(pts, dtype=np.float32)


def write_xyz(points: np.ndarray, out_path: str) -> None:
    """[N,3] -> whitespace .xyz file, one point per line."""
    with open(out_path, "w") as f:
        for p in np.asarray(points):
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def match_pairs(image_names: Sequence[str],
                offsets: Sequence[int] = (60, 61, 70, 71, 80, 81, 90, 91)
                ) -> List[Tuple[str, str]]:
    """Temporal match-pair list for COLMAP's matcher: frame i paired
    with frames i + offset."""
    n = len(image_names)
    pairs = []
    for i in range(n):
        for off in offsets:
            j = i + off
            if j < n:
                pairs.append((image_names[i], image_names[j]))
    return pairs


def write_match_pairs(image_names: Sequence[str], out_path: str,
                      offsets: Sequence[int] = (60, 61, 70, 71, 80, 81,
                                                90, 91)) -> int:
    """Write match_pairs as "a b" lines; returns the pair count."""
    pairs = match_pairs(image_names, offsets)
    with open(out_path, "w") as f:
        for a, b in pairs:
            f.write(f"{a} {b}\n")
    return len(pairs)
