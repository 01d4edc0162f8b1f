"""Shared CLI plumbing (port of fpv4d/cli/common.py): asset loading with
synthetic stand-ins where a licensed artifact (the SMPL-X npz, the
VPoser checkpoint, the PROX body segments) or the scene is not given,
so the pipeline runs end to end without them. A file that is given but
cannot be read raises."""
from __future__ import annotations

import glob
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def device_or_exit(name: str) -> Optional[torch.device]:
    """The torch device `name`, or None (after a message on stderr) when
    it is a CUDA device and no card is present: the CLI then exits
    non-zero and never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"[fpv4d_torch] --device {name}: no CUDA device is "
              "available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return None
    return dev


def load_model(model_path: Optional[str], num_verts: int = 10475,
               device="cpu"):
    """SMPL-X model: the npz if given or found, else synthetic."""
    from fpv4d_torch.models import smplx
    if model_path:
        for cand in (model_path,
                     os.path.join(model_path, "smplx", "SMPLX_NEUTRAL.npz"),
                     os.path.join(model_path, "SMPLX_NEUTRAL.npz")):
            if os.path.isfile(cand):
                print(f"[fpv4d_torch] SMPL-X model: {cand}",
                      file=sys.stderr)
                return smplx.load_npz(cand, device=device)
    print("[fpv4d_torch] SMPL-X npz not found -> synthetic stand-in model "
          f"({num_verts} verts)", file=sys.stderr)
    return smplx.synthetic_model(num_verts=num_verts, device=device)


def load_vposer(ckpt_path: Optional[str], device="cpu"):
    """VPoser decoder params: a torch snapshot (file, or the newest of a
    directory's snapshots/*.pt, *.pt, *.ckp) if one exists, else
    deterministic random weights."""
    from fpv4d_torch.models import vposer
    path = ckpt_path if ckpt_path and os.path.exists(ckpt_path) else None
    if path and os.path.isdir(path):
        snaps = (sorted(glob.glob(os.path.join(path, "snapshots", "*.pt")))
                 + sorted(glob.glob(os.path.join(path, "*.pt")))
                 + sorted(glob.glob(os.path.join(path, "*.ckp"))))
        path = snaps[-1] if snaps else None
    if path and os.path.isfile(path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if "state_dict" in sd:
            sd = sd["state_dict"]
        print(f"[fpv4d_torch] VPoser ckpt: {path}", file=sys.stderr)
        return vposer.params_from_torch_state_dict(sd, device=device)
    print("[fpv4d_torch] VPoser ckpt not found -> deterministic random "
          "decoder", file=sys.stderr)
    return vposer.random_params(device=device)


def load_scene(scene_path: Optional[str], num_pts_fallback: int = 10000
               ) -> np.ndarray:
    """Scene vertices from .ply/.xyz, else a synthetic floor plane."""
    if scene_path and os.path.isfile(scene_path):
        if scene_path.endswith(".ply"):
            from fpv4d_torch.io.ply import read_ply
            return read_ply(scene_path)[0]
        from fpv4d_torch.io.colmap import read_xyz
        return read_xyz(scene_path)
    print("[fpv4d_torch] scene not found -> synthetic floor plane",
          file=sys.stderr)
    g = int(np.sqrt(num_pts_fallback))
    xs, zs = np.meshgrid(np.linspace(-5, 5, g), np.linspace(-5, 5, g))
    return np.stack([xs.ravel(), np.full(g * g, -1.0), zs.ravel()],
                    1).astype(np.float32)


def load_contacts(segments_folder: Optional[str], parts: Sequence[str],
                  num_verts: int) -> np.ndarray:
    from fpv4d_torch.ops import contact
    return contact.contact_ids(segments_folder or "", tuple(parts),
                               num_verts)
