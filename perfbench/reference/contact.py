"""The plain contact nearest-neighbour of the clip solve.

The voxel grid and its per-frame candidate tables are worked out again
here from the scene and the reference's own vertices, following the
configuration's rules (the port derives the same tables at commit
cc31d8d in ``fpv4d_torch/ops/nn.py``; the grid builder below is a frozen
copy of its NumPy loop): each cell keeps the K points of its 3x3x3
neighbourhood nearest its centre; every refresh each frame gathers the
tables of its lowest `budget` distinct cells and keeps the `P_out`
candidates most contended to be a query's nearest, scored in bfloat16.
Distances to a table, to a cell's slots and to the whole scene are
exact float32 differences, ((dx*dx + dy*dy) + dz*dz), the nearest found
by a full scan; the gradient flows through the winner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

BIG = 1e4                 # squared distance where a query has no candidate


@dataclass
class Grid:
    pts: torch.Tensor         # [cells, K, 3]
    idx: torch.Tensor         # [cells, K] scene index, -1 empty
    origin: torch.Tensor      # [3]
    dims: Tuple[int, int, int]
    h: float


def build_grid(points: np.ndarray, h: float, K: int, max_cells: int,
               device) -> Grid:
    """Each cell's K neighbourhood points nearest its centre (NumPy)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    mins = pts.min(axis=0) - h
    maxs = pts.max(axis=0) + h
    dims = np.maximum(1, np.ceil((maxs - mins) / h).astype(np.int64))
    while int(dims.prod()) > max_cells:
        h *= 1.5
        dims = np.maximum(1, np.ceil((maxs - mins) / h).astype(np.int64))
    cells = np.minimum(np.floor((pts - mins) / h).astype(np.int64), dims - 1)
    flat = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    order = np.argsort(flat, kind="stable")
    fs = flat[order]
    n_cells = int(dims.prod())
    starts = np.searchsorted(fs, np.arange(n_cells), "left")
    ends = np.searchsorted(fs, np.arange(n_cells), "right")
    counts = ends - starts
    cand_idx = np.full((n_cells, K), -1, dtype=np.int32)
    cand_pts = np.zeros((n_cells, K, 3), dtype=np.float32)
    occ = np.nonzero(counts > 0)[0]
    mask = np.zeros(n_cells, dtype=bool)
    cx, cy, cz = occ // (dims[1] * dims[2]), (occ // dims[2]) % dims[1], \
        occ % dims[2]
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nx = np.clip(cx + ox, 0, dims[0] - 1)
                ny = np.clip(cy + oy, 0, dims[1] - 1)
                nz = np.clip(cz + oz, 0, dims[2] - 1)
                mask[(nx * dims[1] + ny) * dims[2] + nz] = True
    for c in np.nonzero(mask)[0]:
        x, y, z = c // (dims[1] * dims[2]), (c // dims[2]) % dims[1], \
            c % dims[2]
        idxs = []
        for nx in range(max(x - 1, 0), min(x + 2, dims[0])):
            for ny in range(max(y - 1, 0), min(y + 2, dims[1])):
                for nz in range(max(z - 1, 0), min(z + 2, dims[2])):
                    n = (nx * dims[1] + ny) * dims[2] + nz
                    if counts[n]:
                        idxs.append(order[starts[n]:ends[n]])
        if not idxs:
            continue
        idxs = np.concatenate(idxs)
        if len(idxs) > K:
            center = mins + (np.array([x, y, z]) + 0.5) * h
            d2 = ((pts[idxs] - center) ** 2).sum(1)
            idxs = idxs[np.argsort(d2)[:K]]
        cand_idx[c, :len(idxs)] = idxs
        cand_pts[c, :len(idxs)] = pts[idxs]
    return Grid(pts=torch.as_tensor(cand_pts, device=device),
                idx=torch.as_tensor(cand_idx, device=device),
                origin=torch.as_tensor(mins.astype(np.float32), device=device),
                dims=(int(dims[0]), int(dims[1]), int(dims[2])), h=float(h))


def cell_ids(g: Grid, q: torch.Tensor) -> torch.Tensor:
    c = torch.floor((q - g.origin) / g.h).to(torch.int64)
    cx, cy, cz = (torch.clamp(c[..., a], 0, g.dims[a] - 1) for a in range(3))
    return (cx * g.dims[1] + cy) * g.dims[2] + cz


def dist_sq(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q [T, N, 3], c [T, P, 3] -> [T, N, P], ((dx dx + dy dy) + dz dz)
    in the operands' dtype."""
    dx = q[:, :, None, 0] - c[:, None, :, 0]
    dy = q[:, :, None, 1] - c[:, None, :, 1]
    dz = q[:, :, None, 2] - c[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


@torch.no_grad()
def frame_tables(g: Grid, q: torch.Tensor, budget: int, P_out: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [T, N, 3] -> each frame's candidates (cand [T, P, 3], valid
    [T, P]): the tables of its `budget` lowest distinct cells, then,
    where P_out is below their budget * K slots, the P_out of lowest
    bfloat16 score min_n (d(q_n, c) - d_nn(q_n)), ties to the lower slot."""
    T = q.shape[0]
    K = g.pts.shape[1]
    flat = cell_ids(g, q)
    cand = torch.empty((T, budget * K, 3), device=q.device)
    valid = torch.empty((T, budget * K), dtype=torch.bool, device=q.device)
    for t in range(T):
        u = torch.unique(flat[t])[:budget]                  # sorted
        rows = torch.full((budget,), g.pts.shape[0] - 1, dtype=torch.int64,
                          device=q.device)
        rows[:len(u)] = u
        real = torch.zeros(budget, dtype=torch.bool, device=q.device)
        real[:len(u)] = True
        cand[t] = g.pts[rows].reshape(-1, 3)
        valid[t] = (g.idx[rows] >= 0).reshape(-1) & real.repeat_interleave(K)
    if not P_out or P_out >= budget * K:
        return cand, valid
    big = torch.full((), BIG, dtype=torch.bfloat16, device=q.device)
    d = dist_sq(q.to(torch.bfloat16), cand.to(torch.bfloat16))
    d = torch.where(valid[:, None, :], d, big)
    dnn = torch.min(d, dim=-1, keepdim=True).values
    score = torch.min(d - dnn, dim=1).values.to(torch.float32)
    score = torch.where(valid, score, float("inf"))
    keep = torch.sort(score, dim=1, stable=True).indices[:, :P_out]
    return (torch.gather(cand, 1, keep[..., None].expand(-1, -1, 3)),
            torch.gather(valid, 1, keep))


def _nearest(q: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor
             ) -> torch.Tensor:
    """Differentiable squared distance from q [..., 3] to the nearest of
    its own valid points pts [..., P, 3] (BIG where none is valid)."""
    with torch.no_grad():
        d = (((q[..., None, 0] - pts[..., 0]) ** 2
              + (q[..., None, 1] - pts[..., 1]) ** 2)
             + (q[..., None, 2] - pts[..., 2]) ** 2)
        d = torch.where(valid, d, BIG)
        win = torch.argmin(d, dim=-1)
        none = ~torch.gather(valid, -1, win[..., None])[..., 0]
    p = torch.gather(pts, -2, win[..., None, None].expand(
        win.shape + (1, 3)))[..., 0, :]
    e = q - p
    out = ((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1])
           + e[..., 2] * e[..., 2])
    return torch.where(none, torch.full_like(out, BIG), out)


def nn_tables(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
              frames: int = 64) -> torch.Tensor:
    """q [T, N, 3] against each frame's table -> squared distance [T, N]."""
    outs = []
    N = q.shape[1]
    for a in range(0, q.shape[0], frames):
        c, v = cand[a:a + frames, None], valid[a:a + frames, None]
        outs.append(_nearest(q[a:a + frames],
                             c.expand(-1, N, -1, -1), v.expand(-1, N, -1)))
    return torch.cat(outs)


def nn_grid(g: Grid, q: torch.Tensor) -> torch.Tensor:
    """q [..., 3] against its own cell's K slots -> squared distance."""
    flat = cell_ids(g, q)
    return torch.clamp(_nearest(q, g.pts[flat], g.idx[flat] >= 0), max=BIG)


def nn_scene(q: torch.Tensor, scene: torch.Tensor, chunk: int = 1024
             ) -> torch.Tensor:
    """q [..., 3] against every scene point -> squared distance [...],
    the nearest found by scanning the whole cloud (lowest index on ties)."""
    flat = q.reshape(-1, 3)
    win = torch.empty(flat.shape[0], dtype=torch.int64, device=q.device)
    with torch.no_grad():
        for a in range(0, flat.shape[0], chunk):
            x = flat[a:a + chunk]
            d = (((x[:, None, 0] - scene[None, :, 0]) ** 2
                  + (x[:, None, 1] - scene[None, :, 1]) ** 2)
                 + (x[:, None, 2] - scene[None, :, 2]) ** 2)
            win[a:a + chunk] = torch.argmin(d, dim=1)
    e = flat - scene[win]
    out = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    return out.reshape(q.shape[:-1])
