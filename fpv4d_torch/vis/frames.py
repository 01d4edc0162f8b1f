"""What the ego and world renderers share: the chunked body forward,
the PNG writer, and per-part timings.

The reference decodes VPoser and runs the SMPL-X forward once per
frame; here a directory's frames go through both in chunks of
``FORWARD_CHUNK`` frames on the model's device, and the rasterizer then
runs once per frame.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fpv4d_torch.models import params as P
from fpv4d_torch.models import vposer as VP
from fpv4d_torch.vis.png import encode_png

FORWARD_CHUNK = 64


def body_forward(model, vposer_params, params: Sequence[Dict]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame pkl dicts -> (vertices [B, V, 3], joints [B, 23, 3])
    on the model's device, in one VPoser decode and one SMPL-X call."""
    dev = model.v_template.device
    x = torch.as_tensor(np.vstack([P.from_pkl_dict(p) for p in params]),
                        device=dev)
    with torch.no_grad():
        out = model(body_pose=VP.decode(vposer_params,
                                        P.split(x)["body_pose"]),
                    **P.smplx_kwargs(x))
    return out["vertices"], out["joints"][:, :23]


def save_png(path: str, img: torch.Tensor) -> None:
    """float [H, W, 3] image in [0, 1] -> 8-bit PNG (truncated, as the
    reference's astype(np.uint8)); one copy to the host."""
    with open(path, "wb") as f:
        f.write(encode_png((torch.clamp(img, 0, 1) * 255).to(torch.uint8)))


def lap(stats: Optional[dict], key: str, t0: float, device) -> float:
    """Add the seconds since t0 to stats[key], read after a fence on a
    CUDA device so the part's queued work is in it, and return the time
    now; with stats None, fence nothing and return t0."""
    if stats is None:
        return t0
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    stats[key] = stats.get(key, 0.0) + t - t0
    return t


def count_mask(stats: Optional[dict], mask: torch.Tensor) -> None:
    """Record a frame's body-mask pixels under stats['mask_pixels']."""
    if stats is not None:
        stats.setdefault("mask_pixels", []).append(int(mask.sum()))
