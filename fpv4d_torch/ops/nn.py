"""Contact nearest-neighbour front end (port of fpv4d/ops/nn.py:
VoxelGrid + the NumPy grid builder, grid_min_dist, FrameCands,
frame_candidates, compact_candidates, nn_to_candidates, and the exact
brute-force nn_brute).

The scene is static across the solve, so a voxel grid stores, per cell,
the K scene points of the cell's 3x3x3 neighbourhood. Every
``contact_refresh_steps`` Adam steps each frame gathers the tables of
its <= budget unique cells (frame_candidates), optionally compacted to
the P_out candidates most contended to be some query's NN
(compact_candidates); every step then evaluates the contact distance
against those per-frame tables (nn_to_candidates: the hand-written CUDA
kernel of ops/cand_cuda.py on the card).

Without a grid (``nn_impl='brute'``), nn_brute searches the whole scene
every step: kernel K2 of ops/chamfer_cuda.py on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fpv4d_torch.ops import cand_cuda, chamfer_cuda

BIG = cand_cuda.BIG           # saturation distance^2 for empty neighbourhoods
_FILL_CELL = 2 ** 30


@dataclass
class VoxelGrid:
    """Dense voxel table over the scene bounding box: cand_pts [C, K, 3]
    candidate coordinates per cell, cand_idx [C, K] their scene indices
    (-1 = empty slot), origin [3]; dims and h are static metadata."""
    cand_pts: torch.Tensor
    cand_idx: torch.Tensor
    origin: torch.Tensor
    dims: Tuple[int, int, int]
    h: float


@dataclass
class FrameCands:
    """Per-frame candidate sets: cand [T, P, 3], valid [T, P] bool."""
    cand: torch.Tensor
    valid: torch.Tensor


def build_voxel_grid(points: np.ndarray, h: float = 0.25,
                     slots_per_cell: int = 32, max_cells: int = 500_000,
                     device="cpu") -> VoxelGrid:
    """Host-side construction (once per scene), the reference's NumPy
    path (nn.py:108-185). Overflowing neighbourhoods keep the K points
    nearest the cell centre."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    mins = pts.min(axis=0) - h
    maxs = pts.max(axis=0) + h
    dims = np.maximum(1, np.ceil((maxs - mins) / h).astype(np.int64))
    while int(dims.prod()) > max_cells:      # coarsen to the cell budget
        h *= 1.5
        dims = np.maximum(1, np.ceil((maxs - mins) / h).astype(np.int64))
    cells = np.floor((pts - mins) / h).astype(np.int64)
    cells = np.minimum(cells, dims - 1)
    flat = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]

    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    num_cells = int(dims.prod())
    K = slots_per_cell
    starts = np.searchsorted(flat_sorted, np.arange(num_cells), "left")
    ends = np.searchsorted(flat_sorted, np.arange(num_cells), "right")
    counts = ends - starts

    cand_idx = np.full((num_cells, K), -1, dtype=np.int32)
    cand_pts = np.zeros((num_cells, K, 3), dtype=np.float32)

    # cells whose 3x3x3 neighbourhood holds any point
    occupied = np.nonzero(counts > 0)[0]
    neigh_mask = np.zeros(num_cells, dtype=bool)
    cx = occupied // (dims[1] * dims[2])
    cy = (occupied // dims[2]) % dims[1]
    cz = occupied % dims[2]
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nx = np.clip(cx + ox, 0, dims[0] - 1)
                ny = np.clip(cy + oy, 0, dims[1] - 1)
                nz = np.clip(cz + oz, 0, dims[2] - 1)
                neigh_mask[(nx * dims[1] + ny) * dims[2] + nz] = True

    for c in np.nonzero(neigh_mask)[0]:
        x, y, z = (c // (dims[1] * dims[2]),
                   (c // dims[2]) % dims[1], c % dims[2])
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

    return VoxelGrid(cand_pts=torch.as_tensor(cand_pts, device=device),
                     cand_idx=torch.as_tensor(cand_idx, device=device),
                     origin=torch.as_tensor(mins.astype(np.float32),
                                            device=device),
                     dims=(int(dims[0]), int(dims[1]), int(dims[2])),
                     h=float(h))


def _cell_ids(grid: VoxelGrid, q: torch.Tensor) -> torch.Tensor:
    """q [..., 3] -> flat (clamped) cell id [...] int64."""
    dims = torch.as_tensor(grid.dims, device=q.device)
    cell = torch.floor((q - grid.origin) / grid.h).to(torch.int64)
    cell = torch.minimum(torch.clamp(cell, min=0), dims - 1)
    return ((cell[..., 0] * grid.dims[1] + cell[..., 1]) * grid.dims[2]
            + cell[..., 2])


def grid_min_dist(grid: VoxelGrid, q: torch.Tensor) -> torch.Tensor:
    """Distance-only voxel NN: q [..., 3] -> dist_sq [...] (BIG where the
    query's cell has no candidate). Plain autodiff; torch.amin splits the
    gradient evenly among exactly tied candidates, as JAX's min does
    (torch.min(dim) would send it all to one)."""
    flat = _cell_ids(grid, q)
    pts = grid.cand_pts[flat]                              # [..., K, 3]
    valid = grid.cand_idx[flat] >= 0
    d = torch.sum((q[..., None, :] - pts) ** 2, dim=-1)
    d = torch.where(valid, d, BIG)
    return torch.clamp(torch.amin(d, dim=-1), max=BIG)


def frame_candidates(grid: VoxelGrid, q: torch.Tensor,
                     budget: int = 64) -> FrameCands:
    """q [T, N, 3] -> FrameCands with P = budget * K points per frame:
    the tables of each frame's sorted-ascending unique cells, truncated
    to `budget` (unused slots carry cell 2**30 and are invalid).

    torch has no ``unique(size=)``: each row is sorted, its first
    occurrences are masked, and their ranks scatter the unique ids into
    a [T, budget] table (ranks >= budget go to a dropped column)."""
    T, N, _ = q.shape
    K = grid.cand_pts.shape[-2]
    num_cells = grid.cand_pts.shape[0]
    s = torch.sort(_cell_ids(grid, q), dim=1).values       # [T, N]
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    dest = torch.where(first & (rank < budget), rank, budget)
    uniq = torch.full((T, budget + 1), _FILL_CELL, dtype=torch.int64,
                      device=q.device).scatter_(1, dest, s)[:, :budget]
    safe_u = torch.clamp(uniq, max=num_cells - 1)
    cand = grid.cand_pts[safe_u].reshape(T, budget * K, 3)
    valid = ((grid.cand_idx[safe_u] >= 0).reshape(T, budget * K)
             & (uniq < _FILL_CELL).repeat_interleave(K, dim=-1))
    return FrameCands(cand=cand, valid=valid)


def compact_candidates(q: torch.Tensor, fc: FrameCands,
                       P_out: int) -> FrameCands:
    """Shrink each frame's table to the `P_out` candidates most
    contended to be some query's nearest neighbour.

    score[t, p] = min_n (d(q[t,n], cand[t,p]) - d_nn(q[t,n])), scored in
    bf16 like the reference; it is 0 for every candidate that is some
    query's NN, so keeping the P_out smallest keeps every distinct NN
    while they number <= P_out. Selection is a STABLE ascending sort on
    the score (lax.top_k's tie order: lower index first — score-0 ties
    are the common case). Invalid slots score +inf. P_out >= P returns
    fc unchanged."""
    P = fc.cand.shape[-2]
    if P_out >= P:
        return fc
    d = cand_cuda.dist_sq_tnp(q.to(torch.bfloat16),
                              fc.cand.to(torch.bfloat16))   # [T, N, P]
    big = torch.tensor(BIG, dtype=torch.bfloat16, device=q.device)
    d = torch.where(fc.valid[:, None, :], d, big)
    dnn = torch.min(d, dim=-1, keepdim=True).values
    score = torch.min(d - dnn, dim=1).values.to(torch.float32)   # [T, P]
    score = torch.where(fc.valid, score, float("inf"))
    idx = torch.sort(score, dim=1, stable=True).indices[:, :P_out]
    cand = torch.gather(fc.cand, 1, idx[..., None].expand(-1, -1, 3))
    valid = torch.gather(fc.valid, 1, idx)
    return FrameCands(cand=cand, valid=valid)


def nn_to_candidates(q: torch.Tensor, cands: FrameCands) -> torch.Tensor:
    """q [T, N, 3] vs per-frame candidates -> squared NN distance [T, N]
    (BIG where a frame has no valid candidate), differentiable in q:
    the CUDA kernel on the card, its plain version on the CPU."""
    return cand_cuda.nn_to_candidates(q, cands.cand, cands.valid)


def nn_brute(x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force NN: x [..., 3], y [M, 3] -> (dist_sq [...], idx [...]
    int32), K2 for CUDA tensors and its plain version for CPU tensors,
    with the reference's VJP (dx = g * 2 (x - y[idx]), -dx added into
    dy). The reference re-evaluates |x - y[idx]|^2 after its Gram-form
    search (nn._exact_at); K2's distance already is that difference
    form at the winner, in the same f32 order, so it is returned as is."""
    return chamfer_cuda.nn_distance(x, y)
