"""OpenPose keypoint JSON ingestion (a copy of fpv4d/io/keypoints.py,
NumPy only).

The pipeline consumes OpenPose BODY_25(+hands+face) JSON files: flat
``pose_keypoints_2d`` (x, y, confidence) triplets per person. This
module covers:
  * reading one JSON -> [25,3] body keypoints (+hands/face if present);
  * the single-person filter (people[0], or the most confident);
  * the SMPLify-X rename convention ``%06d_keypoints.json``;
  * bounding-box human masks for COLMAP feature masking;
  * loading a whole clip folder -> [T,25,3] for the keypoint fit.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_BODY25 = 25


def parse_person(person: Dict) -> Dict[str, np.ndarray]:
    """One OpenPose 'people' entry -> dict of [K,3] arrays."""
    out = {}
    for key, n in (("pose_keypoints_2d", NUM_BODY25),
                   ("hand_left_keypoints_2d", 21),
                   ("hand_right_keypoints_2d", 21),
                   ("face_keypoints_2d", 70)):
        flat = person.get(key) or []
        arr = np.asarray(flat, dtype=np.float32).reshape(-1, 3)
        if arr.shape[0] == 0:
            arr = np.zeros((n, 3), dtype=np.float32)
        out[key.replace("_keypoints_2d", "")] = arr
    return out


def read_keypoints(path: str, person: int = 0
                   ) -> Optional[Dict[str, np.ndarray]]:
    """Read one OpenPose JSON; returns None if no person detected."""
    with open(path) as f:
        data = json.load(f)
    people = data.get("people", [])
    if not people:
        return None
    return parse_person(people[person])


def most_confident_person(path: str) -> Optional[int]:
    """Index of the person with the highest total body confidence
    (the selection the openpose_filter step should have used; the
    reference simply keeps people[0])."""
    with open(path) as f:
        data = json.load(f)
    people = data.get("people", [])
    if not people:
        return None
    scores = [np.asarray(p.get("pose_keypoints_2d") or [0],
                         dtype=np.float32).reshape(-1, 3)[:, 2].sum()
              for p in people]
    return int(np.argmax(scores))


def filter_single_person(in_path: str, out_path: str,
                         best: bool = True) -> None:
    """Rewrite a JSON keeping exactly one person
    (utils/openpose_filter.py keeps people[0]; best=True keeps the
    most confident instead)."""
    with open(in_path) as f:
        data = json.load(f)
    people = data.get("people", [])
    if people:
        idx = (most_confident_person(in_path) or 0) if best else 0
        data["people"] = [people[idx]]
    with open(out_path, "w") as f:
        json.dump(data, f)


def rename_for_smplifyx(folder: str, out_folder: Optional[str] = None
                        ) -> List[str]:
    """Rename OpenPose outputs to the %06d_keypoints.json SMPLify-X
    convention, in sorted order (utils/openpose_helper.py:12-20)."""
    out_folder = out_folder or folder
    os.makedirs(out_folder, exist_ok=True)
    files = sorted(glob.glob(os.path.join(folder, "*_keypoints.json")))
    if not files:
        files = sorted(glob.glob(os.path.join(folder, "*.json")))
    out = []
    for i, src in enumerate(files):
        dst = os.path.join(out_folder, f"{i:06d}_keypoints.json")
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst)
        out.append(dst)
    return out


def load_clip_keypoints(folder: str) -> np.ndarray:
    """All keypoint JSONs of a clip (sorted) -> [T,25,3]; frames with
    no detection give all-zero confidence rows."""
    files = sorted(glob.glob(os.path.join(folder, "*.json")))
    frames = []
    for path in files:
        kp = read_keypoints(path)
        frames.append(kp["pose"] if kp is not None
                      else np.zeros((NUM_BODY25, 3), dtype=np.float32))
    return np.stack(frames) if frames else np.zeros((0, NUM_BODY25, 3),
                                                    dtype=np.float32)


def load_clip_keypoints_full(folder: str):
    """Sorted JSONs -> dict with 'pose' [T,25,3], 'hand_left' and
    'hand_right' [T,21,3], 'face' [T,70,3] (zero-confidence where
    absent) — the full OpenPose --face --hand output the pipeline
    requests (README.md step 2, utils/openpose_call.py:6-8 flags)."""
    files = sorted(glob.glob(os.path.join(folder, "*.json")))
    out = {"pose": [], "hand_left": [], "hand_right": [], "face": []}
    for path in files:
        kp = read_keypoints(path)
        for key, n in (("pose", NUM_BODY25), ("hand_left", 21),
                       ("hand_right", 21), ("face", 70)):
            out[key].append(kp[key] if kp is not None
                            else np.zeros((n, 3), dtype=np.float32))
    return {k: (np.stack(v) if v else np.zeros((0, 1, 3), np.float32))
            for k, v in out.items()}


def human_bbox_mask(keypoints: np.ndarray, height: int, width: int,
                    margins: Tuple[float, float, float, float]
                    = (0.95, 0.8, 1.05, 1.2)) -> np.ndarray:
    """Binary [H,W] uint8 mask that BLANKS the human bounding box
    (for COLMAP feature masking; bbox scaled by the reference's
    margin factors x_min*0.95, y_min*0.8, x_max*1.05, y_max*1.2,
    utils/mask_helper.py:46-61). Returns 255 outside the box, 0 inside.
    """
    conf = keypoints[:, 2]
    pts = keypoints[conf > 0, :2]
    mask = np.full((height, width), 255, dtype=np.uint8)
    if pts.shape[0] == 0:
        return mask
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    mx0, my0, mx1, my1 = margins
    x0, y0 = max(0, int(x0 * mx0)), max(0, int(y0 * my0))
    x1, y1 = min(width, int(x1 * mx1)), min(height, int(y1 * my1))
    mask[y0:y1, x0:x1] = 0
    return mask
