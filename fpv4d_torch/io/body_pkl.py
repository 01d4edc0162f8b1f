"""Per-frame body-parameter pkl contract (port of fpv4d/io/body_pkl.py).

Stage handoffs are directories of per-frame pickles: SMPLify-X outputs
under ``body_gen/results/*/*.pkl`` (or a flat directory of pkls) in,
``<fit_path>/body_gen_%06d.pkl`` out. Each dict holds [1, k] float
arrays keyed transl / global_orient / betas / body_pose /
left_hand_pose / right_hand_pose / camera_translation, plus, for
clip-solve outputs, the scalar 'scale' and the [4, 4] 'camera_ext';
keypoint-fit outputs with face keypoints add jaw_pose / expression.
Unpickling runs code: read only pkls this pipeline wrote.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from fpv4d_torch.models import params as P


def load_frame(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_frame(path: str, param: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(param, f)


def list_body_gen(body_path: str) -> List[str]:
    """SMPLify-X output layout <body_path>/results/*/*.pkl, else the
    flat <body_path>/*.pkl, sorted."""
    pkls = sorted(glob.glob(os.path.join(body_path, "results", "*",
                                         "*.pkl")))
    if not pkls:
        pkls = sorted(glob.glob(os.path.join(body_path, "*.pkl")))
    return pkls


def load_clip(body_path: str) -> np.ndarray:
    """Directory of per-frame pkls -> packed [T, 75] parameters."""
    rows = [P.from_pkl_dict(load_frame(p)) for p in list_body_gen(body_path)]
    if not rows:
        raise FileNotFoundError(f"no body pkls under {body_path}")
    return np.vstack(rows)


def save_clip(fit_path: str, body_75: np.ndarray,
              scale: Optional[float] = None,
              camera_ext: Optional[np.ndarray] = None,
              prefix: str = "body_gen_",
              extra: Optional[Dict[str, np.ndarray]] = None) -> List[str]:
    """[T, 75] (+ scale / camera_ext) -> per-frame pkls
    ``<fit_path>/<prefix>%06d.pkl``; returns their paths. extra: [T, ...]
    arrays stored per frame under their own keys (the keypoint fit's
    jaw_pose and expression)."""
    os.makedirs(fit_path, exist_ok=True)
    paths = []
    for i, d in enumerate(P.encapsulate_frames(body_75, scale, camera_ext)):
        if extra:
            d = dict(d, **{k: np.asarray(v[i]) for k, v in extra.items()})
        path = os.path.join(fit_path, f"{prefix}{i:06d}.pkl")
        save_frame(path, d)
        paths.append(path)
    return paths


def save_smoothed(fit_path: str, body_75: np.ndarray) -> List[str]:
    """The smoother's layout: ``<fit_path>/smoothed_body/%06d.pkl``."""
    return save_clip(os.path.join(fit_path, "smoothed_body"), body_75,
                     prefix="")


def flatten_smplifyx_results(src_root: str, dst_dir: str) -> int:
    """Copy <src_root>/results/*/*.pkl, sorted, to
    <dst_dir>/body_gen_%06d.pkl byte for byte; returns the count."""
    os.makedirs(dst_dir, exist_ok=True)
    pkls = sorted(glob.glob(os.path.join(src_root, "results", "*",
                                         "*.pkl")))
    for i, src in enumerate(pkls):
        with open(src, "rb") as f:
            data = f.read()
        with open(os.path.join(dst_dir, f"body_gen_{i:06d}.pkl"),
                  "wb") as f:
            f.write(data)
    return len(pkls)
