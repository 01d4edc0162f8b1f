"""Contact nearest-neighbour front end (port of fpv4d/ops/nn.py:
VoxelGrid + the NumPy grid builder, grid_min_dist, FrameCands,
frame_candidates, compact_candidates, nn_to_candidates, and the exact
brute-force nn_brute; for the multi-clip fleet, build_voxel_grid_batch,
frame_candidates_folded and grid_min_dist_folded).

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

A fleet of C clips folds its clips into frames: a batched grid holds C
tables with shared dims and h, and the folded functions take queries
[C*T, ...] whose frame t belongs to clip t // T, offsetting each frame's
cell ids into the concatenated tables. K1 then sees [C*T, N, P] tables
in one launch; K2 searches each clip's padded scene in one launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fpv4d_torch.ops import cand_cuda, chamfer_cuda

BIG = cand_cuda.BIG           # saturation distance^2 for empty neighbourhoods
_FILL_CELL = 2 ** 30


@dataclass
class VoxelGrid:
    """Dense voxel table over the scene bounding box: cand_pts
    [cells, K, 3] candidate coordinates per cell, cand_idx [cells, K]
    their scene indices (-1 = empty slot), origin [3]; dims and h are
    static metadata. A batched grid (build_voxel_grid_batch) has a
    leading clip axis on the three tensors and shares dims and h."""
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
                     device="cpu", use_native: bool = True) -> VoxelGrid:
    """Host-side construction (once per scene). Overflowing
    neighbourhoods keep the K points nearest the cell centre.

    use_native: the C++ builder (io/native.py, the reference's native
    route; a build failure raises, with no fallback), else the NumPy
    loop below, the reference's NumPy path (nn.py:108-185): the same
    tables but for the order of points tied in distance to a cell's
    centre, seconds instead of a fraction of one at 1e5 points."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if use_native:
        from fpv4d_torch.io import native
        cand_pts, cand_idx, origin, dims, h_out = native.build_cand_tables(
            pts, h, slots_per_cell, max_cells)
        return VoxelGrid(cand_pts=torch.as_tensor(cand_pts, device=device),
                         cand_idx=torch.as_tensor(cand_idx, device=device),
                         origin=torch.as_tensor(origin, device=device),
                         dims=dims, h=h_out)
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


def build_voxel_grid_batch(scenes, h: float = 0.25,
                           slots_per_cell: int = 32,
                           max_cells: int = 500_000,
                           device="cpu", use_native: bool = True
                           ) -> VoxelGrid:
    """One grid per clip, batched (the reference's nn.py:188-234): leaves
    [C, ...] with shared dims (the per-axis maxima) and h (the coarsest
    any clip's cell budget chose; when one clip coarsens h, every clip is
    rebuilt at it). Each clip's table is scattered into the common dims
    with EDGE replication, not zeros: the query path clamps cells
    against the common dims, so a query beyond a smaller clip's box lands
    on a copy of its edge cell, as the single-clip clamp does.
    use_native picks build_voxel_grid's route."""
    def build(s, h_):
        return build_voxel_grid(np.asarray(s), h=h_,
                                slots_per_cell=slots_per_cell,
                                max_cells=max_cells, use_native=use_native)

    built = []
    h_common = h
    for s in scenes:
        g = build(s, h_common)
        h_common = max(h_common, g.h)
        built.append(g)
    if any(g.h != h_common for g in built):
        built = [build(s, h_common) for s in scenes]
    dims = tuple(int(max(g.dims[a] for g in built)) for a in range(3))
    num_cells, K = int(np.prod(dims)), slots_per_cell
    pts = np.zeros((len(built), num_cells, K, 3), np.float32)
    idx = np.full((len(built), num_cells, K), -1, np.int32)
    origins = np.zeros((len(built), 3), np.float32)
    for c, g in enumerate(built):
        pad = tuple((0, dims[a] - g.dims[a]) for a in range(3))
        pts[c] = np.pad(g.cand_pts.numpy().reshape(g.dims + (K, 3)),
                        pad + ((0, 0), (0, 0)),
                        mode="edge").reshape(num_cells, K, 3)
        idx[c] = np.pad(g.cand_idx.numpy().reshape(g.dims + (K,)),
                        pad + ((0, 0),), mode="edge").reshape(num_cells, K)
        origins[c] = g.origin.numpy()
    return VoxelGrid(cand_pts=torch.as_tensor(pts, device=device),
                     cand_idx=torch.as_tensor(idx, device=device),
                     origin=torch.as_tensor(origins, device=device),
                     dims=dims, h=float(h_common))


def _cell_ids(grid: VoxelGrid, q: torch.Tensor,
              origin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [..., 3] -> flat (clamped) cell id [...] int64; `origin`
    (broadcast against q) replaces the grid's own."""
    origin = grid.origin if origin is None else origin
    cell = torch.floor((q - origin) / grid.h).to(torch.int64)
    # clamped axis by axis against the host's dims: no host-to-device
    # copy in a step (a captured step cannot make one)
    cx, cy, cz = (torch.clamp(cell[..., a], 0, grid.dims[a] - 1)
                  for a in range(3))
    return (cx * grid.dims[1] + cy) * grid.dims[2] + cz


def _fold(grid_b: VoxelGrid, q: torch.Tensor, C: int):
    """A batched grid and folded queries [C*T, ..., 3] -> (each frame's
    origin, broadcast against q; each frame's row offset [C*T, 1, ...]
    into the concatenated tables; the tables cand_pts [C*cells, K, 3]
    and cand_idx [C*cells, K])."""
    CT = q.shape[0]
    if CT % C:
        raise ValueError(f"{CT} folded frames do not split into {C} clips")
    cells, K = grid_b.cand_pts.shape[1:3]
    lead = (CT,) + (1,) * (q.ndim - 1)
    origin = grid_b.origin.repeat_interleave(CT // C, dim=0)
    offs = (torch.arange(C, device=q.device) * cells).repeat_interleave(
        CT // C)
    return (origin.reshape(lead[:-1] + (3,)), offs.reshape(lead[:-1]),
            grid_b.cand_pts.reshape(C * cells, K, 3),
            grid_b.cand_idx.reshape(C * cells, K))


def _min_dist(q: torch.Tensor, flat: torch.Tensor, cand_pts: torch.Tensor,
              cand_idx: torch.Tensor) -> torch.Tensor:
    pts = cand_pts[flat]                                   # [..., K, 3]
    valid = cand_idx[flat] >= 0
    d = torch.sum((q[..., None, :] - pts) ** 2, dim=-1)
    d = torch.where(valid, d, BIG)
    return torch.clamp(torch.amin(d, dim=-1), max=BIG)


def grid_min_dist(grid: VoxelGrid, q: torch.Tensor) -> torch.Tensor:
    """Distance-only voxel NN: q [..., 3] -> dist_sq [...] (BIG where the
    query's cell has no candidate). Plain autodiff; torch.amin splits the
    gradient evenly among exactly tied candidates, as JAX's min does
    (torch.min(dim) would send it all to one)."""
    return _min_dist(q, _cell_ids(grid, q), grid.cand_pts, grid.cand_idx)


def grid_min_dist_folded(grid_b: VoxelGrid, q: torch.Tensor,
                         C: int) -> torch.Tensor:
    """grid_min_dist over a batched grid with the clips folded into
    frames: q [C*T, ..., 3], frame t against clip t // T's table ->
    dist_sq [C*T, ...] (what the reference gets by vmapping grid_min_dist
    over per-clip grids)."""
    origin, offs, pts, idx = _fold(grid_b, q, C)
    return _min_dist(q, _cell_ids(grid_b, q, origin) + offs, pts, idx)


def frame_candidates(grid: VoxelGrid, q: torch.Tensor,
                     budget: int = 64,
                     out: Optional[FrameCands] = None) -> FrameCands:
    """q [T, N, 3] -> FrameCands with P = budget * K points per frame:
    the tables of each frame's sorted-ascending unique cells, truncated
    to `budget` (unused slots carry cell 2**30 and are invalid); written
    into `out`'s tensors when given.

    torch has no ``unique(size=)``: each row is sorted, its first
    occurrences are masked, and their ranks scatter the unique ids into
    a [T, budget] table (ranks >= budget go to a dropped column)."""
    return _frame_tables(_cell_ids(grid, q), grid.cand_pts, grid.cand_idx,
                         grid.cand_pts.shape[0], budget, out=out)


def frame_candidates_folded(grid_b: VoxelGrid, q_flat: torch.Tensor,
                            C: int, budget: int = 64,
                            out: Optional[FrameCands] = None) -> FrameCands:
    """frame_candidates over a batched grid with the clips folded into
    frames (the reference's nn.py:359-396): q_flat [C*T, N, 3], frame t
    against clip t // T's table -> FrameCands [C*T, budget * K]. Each
    frame's unique cell ids are offset by its clip's start in the
    concatenated tables, so one row gather serves every clip; the tables
    are those of frame_candidates on each clip's own grid."""
    origin, offs, pts, idx = _fold(grid_b, q_flat, C)
    return _frame_tables(_cell_ids(grid_b, q_flat, origin), pts, idx,
                         grid_b.cand_pts.shape[1], budget, offs, out)


def _frame_tables(flat: torch.Tensor, cand_pts: torch.Tensor,
                  cand_idx: torch.Tensor, num_cells: int, budget: int,
                  offs: Optional[torch.Tensor] = None,
                  out: Optional[FrameCands] = None) -> FrameCands:
    """Cell ids [T, N] -> the tables of each frame's sorted unique cells;
    `offs` [T, 1] shifts a frame's rows into concatenated tables; the
    last gather and mask write into `out` when given."""
    T = flat.shape[0]
    K = cand_pts.shape[-2]
    s = torch.sort(flat, dim=1).values                     # [T, N]
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    dest = torch.where(first & (rank < budget), rank, budget)
    uniq = torch.full((T, budget + 1), _FILL_CELL, dtype=torch.int64,
                      device=flat.device).scatter_(1, dest, s)[:, :budget]
    safe_u = torch.clamp(uniq, max=num_cells - 1)
    if offs is not None:
        safe_u = safe_u + offs
    if out is None:
        out = FrameCands(
            cand=torch.empty((T, budget * K, 3), dtype=cand_pts.dtype,
                             device=flat.device),
            valid=torch.empty((T, budget * K), dtype=torch.bool,
                              device=flat.device))
    rows = safe_u.reshape(-1)
    torch.index_select(cand_pts, 0, rows, out=out.cand.view(T * budget, K, 3))
    torch.bitwise_and(
        (cand_idx.index_select(0, rows) >= 0).reshape(T, budget * K),
        (uniq < _FILL_CELL).repeat_interleave(K, dim=-1), out=out.valid)
    return out


def compact_candidates(q: torch.Tensor, fc: FrameCands, P_out: int,
                       out: Optional[FrameCands] = None) -> FrameCands:
    """Shrink each frame's table to the `P_out` candidates most
    contended to be some query's nearest neighbour.

    score[t, p] = min_n (d(q[t,n], cand[t,p]) - d_nn(q[t,n])), scored in
    bf16 like the reference; it is 0 for every candidate that is some
    query's NN, so keeping the P_out smallest keeps every distinct NN
    while they number <= P_out. Selection is a STABLE ascending sort on
    the score (lax.top_k's tie order: lower index first — score-0 ties
    are the common case). Invalid slots score +inf. P_out >= P returns
    fc unchanged. The selections are gathered into `out`'s tensors when
    given."""
    P = fc.cand.shape[-2]
    if P_out >= P:
        return fc
    d = cand_cuda.dist_sq_tnp(q.to(torch.bfloat16),
                              fc.cand.to(torch.bfloat16))   # [T, N, P]
    d = torch.where(fc.valid[:, None, :], d, bf16_big(q.device))
    dnn = torch.min(d, dim=-1, keepdim=True).values
    score = torch.min(d - dnn, dim=1).values.to(torch.float32)   # [T, P]
    score = torch.where(fc.valid, score, float("inf"))
    idx = torch.sort(score, dim=1, stable=True).indices[:, :P_out]
    if out is None:
        out = FrameCands(cand=fc.cand.new_empty(idx.shape + (3,)),
                         valid=fc.valid.new_empty(idx.shape))
    torch.gather(fc.cand, 1, idx[..., None].expand(-1, -1, 3), out=out.cand)
    torch.gather(fc.valid, 1, idx, out=out.valid)
    return out


def bf16_big(device) -> torch.Tensor:
    """BIG in bf16, a 0-d tensor made on `device` (a refresh captured as
    a graph uploads nothing)."""
    return torch.full((), BIG, dtype=torch.bfloat16, device=device)


def nn_to_candidates(q: torch.Tensor, cands: FrameCands) -> torch.Tensor:
    """q [T, N, 3] vs per-frame candidates -> squared NN distance [T, N]
    (BIG where a frame has no valid candidate), differentiable in q:
    the CUDA kernel on the card, its plain version on the CPU."""
    return cand_cuda.nn_to_candidates(q, cands.cand, cands.valid)


def nn_brute(x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force NN: x [..., 3], y [M, 3] -> (dist_sq [...], idx [...]
    int32), or per clip for clouds y [C, M, 3] and x [C, ..., 3] (one
    launch), K2 for CUDA tensors and its plain version for CPU tensors,
    with the reference's VJP (dx = g * 2 (x - y[idx]), -dx added into
    dy). The reference re-evaluates |x - y[idx]|^2 after its Gram-form
    search (nn._exact_at); K2's distance already is that difference
    form at the winner, in the same f32 order, so it is returned as is."""
    return chamfer_cuda.nn_distance(x, y)
