"""Chamfer and nearest-neighbour distances in the Gram form (port of
fpv4d/ops/chamfer_ref.py, the reference's plain oracle).

Every distance here is |x|^2 + |y|^2 - 2 x.y, one f32 product per pair
block (TF32 is off: the package turns it off), as the reference
computes it at HIGHEST precision outside any Pallas kernel. The form
rounds differently from the difference form, by up to a few ulps of
|x|^2 + |y|^2, so a winner among near-ties may differ from an exact
search's.

Not to be confused with ``ops/chamfer_cuda.nn_distance_ref``: that is
kernel K2's contract through its own plain version (the exact
difference form, bit-identical to the kernel), which the solver uses.
"""
from __future__ import annotations

from typing import Tuple

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., M, 3] -> [..., N, M] squared distances
    |x|^2 + |y|^2 - 2 x.y."""
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    xy = torch.matmul(x, y.transpose(-1, -2))
    return xx[..., :, None] + yy[..., None, :] - 2.0 * xy


def nn_distance_ref(x: torch.Tensor, y: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each point of x [..., N, 3], the squared distance to (and
    index of) its nearest neighbour in y [..., M, 3] (batch dims
    broadcast) -> (dist [..., N] clamped at 0, idx [..., N] int32; ties
    to the smallest index)."""
    d, i = pairwise_sqdist(x, y).min(dim=-1)
    return d.clamp(min=0.0), i.to(torch.int32)


def nn_distance_chunked(x: torch.Tensor, y: torch.Tensor,
                        query_chunk: int = 8192, scene_chunk: int = 8192
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact NN in bounded memory: x [..., 3] any leading shape, y [M,
    3] -> (dist [...], idx [...] int32). Streams the scene in chunks
    with a running (min, argmin) per query chunk, so no more than a
    [query_chunk, scene_chunk] block exists at once. Ties: an earlier
    chunk keeps its winner (strict <), and within a chunk the smallest
    index wins, the reference's rule."""
    batch_shape = x.shape[:-1]
    q = x.reshape(-1, 3)
    ds, ids = [], []
    for s in range(0, q.shape[0], query_chunk):
        qc = q[s:s + query_chunk]
        qq = torch.sum(qc * qc, dim=-1)
        best_d = torch.full((qc.shape[0],), float("inf"), dtype=x.dtype,
                            device=x.device)
        best_i = torch.zeros(qc.shape[0], dtype=torch.int32,
                             device=x.device)
        for base in range(0, y.shape[0], scene_chunk):
            yc = y[base:base + scene_chunk]
            yy = torch.sum(yc * yc, dim=-1)
            d = qq[:, None] + yy[None, :] - 2.0 * torch.matmul(qc, yc.T)
            dmin, darg = d.min(dim=1)
            better = dmin < best_d
            best_d = torch.where(better, dmin, best_d)
            best_i = torch.where(better, darg.to(torch.int32) + base,
                                 best_i)
        ds.append(best_d.clamp(min=0.0))
        ids.append(best_i)
    if not ds:
        return (x.new_empty(batch_shape),
                torch.empty(batch_shape, dtype=torch.int32,
                            device=x.device))
    return (torch.cat(ds).reshape(batch_shape),
            torch.cat(ids).reshape(batch_shape))


def chamfer_ref(x: torch.Tensor, y: torch.Tensor):
    """The full 4-tuple (dist_x, dist_y, idx_x, idx_y) of
    chamfer_python.distChamfer: x [..., N, 3], y [..., M, 3]."""
    d = pairwise_sqdist(x, y)
    dx, ix = d.min(dim=-1)
    dy, iy = d.min(dim=-2)
    return (dx.clamp(min=0.0), dy.clamp(min=0.0), ix.to(torch.int32),
            iy.to(torch.int32))
