"""Scene-SDF collision term (port of fpv4d/ops/sdf.py).

  * ``SdfGrid``: a dense [Dx, Dy, Dz] signed-distance grid over an
    axis-aligned box (the PROX on-disk format: ``<scene>_sdf.npy`` plus
    a json with ``min``/``max``/``dim``), read by ``load_prox_sdf`` or
    made synthetically (``plane_sdf``).
  * ``sample``: trilinear SDF value and analytic gradient at arbitrary
    points. It gathers, so it runs at refresh time only.
  * ``linearize`` / ``collision_penalty``: every refresh samples the
    SDF and its gradient at the current vertices; each step's penalty is
    the gather-free linearized field relu(-(s0 + g . (v - v0))).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SdfGrid:
    """Dense SDF over the box [mins, maxs]; values [Dx, Dy, Dz] f32,
    grid-node convention (node i at mins + i * (maxs - mins) / (D - 1))."""
    values: torch.Tensor
    mins: torch.Tensor              # [3]
    maxs: torch.Tensor              # [3]

    def to(self, device) -> "SdfGrid":
        return SdfGrid(self.values.to(device), self.mins.to(device),
                       self.maxs.to(device))


def load_prox_sdf(json_path: str, npy_path: str, device="cpu") -> SdfGrid:
    """PROX scene-SDF artifacts: json {'min': [3], 'max': [3], 'dim': D}
    + a flat npy of D^3 values."""
    with open(json_path) as f:
        meta = json.load(f)
    d = int(meta["dim"])
    vals = np.load(npy_path).reshape(d, d, d).astype(np.float32)

    def vec(v):
        return torch.tensor(np.asarray(v, np.float32).reshape(3),
                            device=device)

    return SdfGrid(values=torch.tensor(vals, device=device),
                   mins=vec(meta["min"]), maxs=vec(meta["max"]))


def plane_sdf(y0: float = -1.0, extent: float = 6.0, dim: int = 32,
              device="cpu") -> SdfGrid:
    """Synthetic SDF of the half-space y <= y0 (a floor plane)."""
    lin = np.linspace(-extent, extent, dim, dtype=np.float32)
    y = np.broadcast_to(lin[None, :, None], (dim, dim, dim))
    box = torch.full((3,), extent, dtype=torch.float32, device=device)
    return SdfGrid(values=torch.tensor((y - y0).astype(np.float32),
                                       device=device),
                   mins=-box, maxs=box.clone())


def dims(shape, dtype, device) -> torch.Tensor:
    """A grid's dims [3] as a tensor made on `device` (a linearization
    captured as a graph uploads nothing): torch.tensor(shape)'s values."""
    return torch.stack([torch.full((), d, dtype=dtype, device=device)
                        for d in shape])


def sample(sdf: SdfGrid, pts: torch.Tensor, out=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear SDF value + analytic gradient at pts [..., 3] ->
    (s [...], g [..., 3]), written into the pair `out` when given. Points
    outside the box clamp to it."""
    shape = sdf.values.shape
    D = dims(shape, torch.float32, pts.device)
    cell = (sdf.maxs - sdf.mins) / (D - 1.0)
    u = torch.clamp((pts - sdf.mins) / cell, min=0.0)
    u = torch.minimum(u, D - 1.0)
    # the base corner is clamped to D-2 in integers: a float epsilon is
    # below f32 ulp for large grids and would round back to D-1
    top = dims(shape, torch.int64, pts.device) - 2
    i0 = torch.minimum(torch.clamp(torch.floor(u).to(torch.int64), min=0),
                       top)
    f = torch.clamp(u - i0, 0.0, 1.0)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def at(dx, dy, dz):
        return sdf.values[ix + dx, iy + dy, iz + dz]

    c000, c100 = at(0, 0, 0), at(1, 0, 0)
    c010, c110 = at(0, 1, 0), at(1, 1, 0)
    c001, c101 = at(0, 0, 1), at(1, 0, 1)
    c011, c111 = at(0, 1, 1), at(1, 1, 1)

    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    s_out, g_out = out if out is not None else (None, None)
    s = torch.add(c0 * (1 - fz), c1 * fz, out=s_out)

    gx = ((c100 - c000) * (1 - fy) + (c110 - c010) * fy) * (1 - fz) \
        + ((c101 - c001) * (1 - fy) + (c111 - c011) * fy) * fz
    gy = (c10 - c00) * (1 - fz) + (c11 - c01) * fz
    gz = c1 - c0
    g = torch.div(torch.stack([gx, gy, gz], dim=-1), cell, out=g_out)
    return s, g


@dataclass(frozen=True)
class SdfLin:
    """Per-refresh linearization: s0 [T,N], g [T,N,3], v0 [T,N,3] such
    that sdf(v) ~= s0 + g . (v - v0) near v0."""
    s0: torch.Tensor
    g: torch.Tensor
    v0: torch.Tensor


def linearize(sdf: SdfGrid, verts_w: torch.Tensor,
              out: Optional[SdfLin] = None) -> SdfLin:
    """Sample the SDF and its gradient at the current world vertices
    (refresh time; no gradient flows through the tables), into `out`'s
    tensors when given (v0 is then a copy of the vertices)."""
    with torch.no_grad():
        v0 = verts_w.detach()
        if out is None:
            s0, g = sample(sdf, v0)
            return SdfLin(s0=s0, g=g, v0=v0)
        sample(sdf, v0, out=(out.s0, out.g))
        out.v0.copy_(v0)
    return out


def collision_penalty(verts_w: torch.Tensor, lin: SdfLin) -> torch.Tensor:
    """Mean penetration depth under the linearized SDF: relu(-sdf), exact
    at the refresh point and first-order in the drift since."""
    s = lin.s0 + torch.sum(lin.g * (verts_w - lin.v0), dim=-1)
    return torch.mean(torch.relu(-s))
