"""Device rasterizer (port of fpv4d/vis/raster.py): the same pinhole
camera, raymond light rig and painter's-order results, computed with
torch ops on the device of the tensors it is given, with neither OpenCV
nor PIL.

The reference fills each face with ``cv2.fillConvexPoly(..., LINE_8)``
at rounded integer vertices, far to near, so at every pixel the last
face drawn wins. Here each face's coverage is enumerated as row spans
(plus its three 8-connected outline lines), each covered pixel takes
the face's rank in the far-to-near order, and a ``scatter_reduce``
amax over an [H*W] buffer picks the last face drawn. The span and line
arithmetic is OpenCV's, in closed form: 16.16 fixed-point edges with a
rounded per-row step, spans from ``round(left)`` to ``round(right)``
over the rows ``ymin .. ymax - 1``, and Bresenham lines from
``leftToRight`` endpoints after Cohen-Sutherland clipping. Discs
(``cv2.circle`` with ``thickness=-1``) are the integer midpoint circle
as a stencil of pixel offsets.

Camera model: the pinhole IntrinsicsCamera of the reference (fx=fy=692,
cx=640, cy=360) with the OpenGL convention (look down -Z, +Y up).
Images are float32 [H, W, 3] tensors, masks [H, W, 1].
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# raymond light rig: three directional lights in a triangle overhead
_RAYMOND_DIRS = np.array([
    [0.0, -1.0, -1.0],
    [0.866, 0.5, -1.0],
    [-0.866, 0.5, -1.0],
], dtype=np.float32)
_RAYMOND_DIRS /= np.linalg.norm(_RAYMOND_DIRS, axis=1, keepdims=True)
_RAYMOND_INTENSITY = np.array([0.45, 0.35, 0.35], dtype=np.float32)

_ONE = 1 << 16                 # OpenCV's 16.16 fixed-point edges
_HALF = _ONE >> 1
# face-rows plus outline pixels enumerated at once: bounds the fill's
# scratch memory (about 65 bytes each, ~1.1 GiB) whatever the mesh and
# image size. The card is launch-bound here: a smaller cap costs a
# chunk's ~530 launches again for each further chunk
CHUNK = 1 << 24


@dataclass
class Camera:
    """Pinhole intrinsics; OpenGL view convention (look down -Z)."""
    fx: float = 692.0
    fy: float = 692.0
    cx: float = 640.0
    cy: float = 360.0
    width: int = 1280
    height: int = 720

    def project(self, pts_cam: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N,3] camera-space -> ([N,2] pixels, [N] depth>0 in front).

        GL convention: visible points have z < 0; depth = -z. Image y
        grows downward, so v = cy - fy * y / depth."""
        z = -pts_cam[:, 2]
        depth = torch.clamp(z, min=1e-6)
        u = self.fx * pts_cam[:, 0] / depth + self.cx
        v = self.cy - self.fy * pts_cam[:, 1] / depth
        return torch.stack([u, v], dim=1), z


def _shade(normals: torch.Tensor, base_color: torch.Tensor,
           ambient: float = 0.3) -> torch.Tensor:
    """Lambertian under the raymond rig. normals [F,3] -> colors [F,3]."""
    dirs = torch.from_numpy(_RAYMOND_DIRS).to(normals.device)
    lam = torch.zeros(normals.shape[0], dtype=torch.float32,
                      device=normals.device)
    for d, w in zip(dirs, _RAYMOND_INTENSITY.tolist()):
        lam = lam + np.float32(w) * torch.clamp(normals @ (-d), min=0.0)
    inten = torch.clamp(ambient + lam, 0.0, 1.0)[:, None]
    return torch.clamp(inten * base_color[None, :], 0.0, 1.0)


def _to_u8(img: torch.Tensor) -> torch.Tensor:
    """float image -> uint8 by truncation (numpy's astype(np.uint8))."""
    return (img * 255).to(torch.uint8)


def _base(image: Optional[torch.Tensor], camera: Camera,
          device) -> torch.Tensor:
    if image is None:
        return torch.zeros((camera.height, camera.width, 3),
                           dtype=torch.float32, device=device)
    return image.to(device=device, dtype=torch.float32).clone()


# -- coverage: spans, lines, discs ------------------------------------------

def _span_rows(p: torch.Tensor, H: int):
    """First row and number of rows the fill spans for each triangle
    p [F,3,2]: ymin .. ymax - 1, clipped to [0, H)."""
    ys = p[..., 1]
    y_lo = torch.clamp(ys.min(dim=1).values, min=0)
    y_hi = torch.clamp(ys.max(dim=1).values - 1, max=H - 1)
    return y_lo, torch.clamp(y_hi - y_lo + 1, min=0)


def _fill_spans(p: torch.Tensor, H: int, W: int):
    """Row spans of cv2.fillConvexPoly(LINE_8) for triangles p [F,3,2]
    (int64 pixel vertices, shift 0): (face [R], row [R], x0 [R], x1 [R])
    over the rows of [0, H) the fill draws; x0 <= x1 are clipped to
    [0, W) and a span with x0 > x1 draws nothing.

    The scan starts at the first vertex of least y; edge 0 walks the
    vertices forward, edge 1 backward. An edge picked at row y0 from
    vertex P towards Q (the first vertex below y0) steps by
    dx = ((xQ - xP) * 2 + dy) / (2 * dy) in 16.16 fixed point (C
    division), dy = yQ - y0, so x(y) = xP + (y - y0) dx. The last row
    (ymax) is never spanned: the edges run out there, and the outline
    lines cover it."""
    dev = p.device
    F = p.shape[0]
    xs, ys = p[..., 0], p[..., 1]
    # first index of the least y (cv2's strict `<` scan)
    imin = ys.argmin(dim=1)
    ar = torch.arange(F, device=dev)
    chains = []
    for di in (1, 2):                          # forward, backward
        c1 = (imin + di) % 3
        c2 = (imin + 2 * di) % 3
        chains.append(tuple((xs[ar, c], ys[ar, c]) for c in (imin, c1, c2)))
    y_lo, n_rows = _span_rows(p, H)
    face = torch.repeat_interleave(torch.arange(F, device=dev), n_rows)
    start = torch.cumsum(n_rows, 0) - n_rows
    y = (torch.arange(face.shape[0], device=dev) - start[face]
         + y_lo[face])
    xe = []
    for (x0, y0), (x1, y1), (x2, y2) in chains:
        first = y < y1[face]
        px = torch.where(first, x0[face], x1[face])
        py = torch.where(first, y0[face], y1[face])
        qx = torch.where(first, x1[face], x2[face])
        qy = torch.where(first, y1[face], y2[face])
        dy = torch.clamp(qy - py, min=1)
        step = torch.div((qx - px) * (_ONE * 2) + dy, 2 * dy,
                         rounding_mode="trunc")
        xe.append(px * _ONE + (y - py) * step)
    left = torch.minimum(xe[0], xe[1])
    right = torch.maximum(xe[0], xe[1])
    xl = torch.clamp(torch.div(left + _HALF, _ONE, rounding_mode="floor"),
                     min=0)
    xr = torch.clamp(torch.div(right + _HALF, _ONE, rounding_mode="floor"),
                     max=W - 1)
    return face, y, xl, xr


def _clip_lines(a: torch.Tensor, b: torch.Tensor, H: int, W: int):
    """cv2.clipLine on segments a -> b [L,2] (int64) against a W x H
    image: the clipped endpoints and whether anything is left. The
    updates are sequential, each reading the coordinates already
    clipped, with the same double arithmetic truncated to integers."""
    right, bottom = W - 1, H - 1
    x1, y1, x2, y2 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]

    def code(x, y):
        return ((x < 0).long() + (x > right).long() * 2
                + (y < 0).long() * 4 + (y > bottom).long() * 8)

    def shifted(base, num_a, num, den, active):
        den = torch.where(active, den, torch.ones_like(den))
        return base + torch.trunc(num_a.double() * num.double()
                                  / den.double()).long()

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo & ((c1 & 12) != 0)
    ya = torch.where(c1 < 8, 0, bottom)
    x1 = torch.where(m, shifted(x1, ya - y1, x2 - x1, y2 - y1, m), x1)
    y1 = torch.where(m, ya, y1)
    c1 = torch.where(m, (x1 < 0).long() + (x1 > right).long() * 2, c1)
    m = todo & ((c2 & 12) != 0)
    ya = torch.where(c2 < 8, 0, bottom)
    x2 = torch.where(m, shifted(x2, ya - y2, x2 - x1, y2 - y1, m), x2)
    y2 = torch.where(m, ya, y2)
    c2 = torch.where(m, (x2 < 0).long() + (x2 > right).long() * 2, c2)
    todo2 = todo & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo2 & (c1 != 0)
    xa = torch.where(c1 == 1, 0, right)
    y1 = torch.where(m, shifted(y1, xa - x1, y2 - y1, x2 - x1, m), y1)
    x1 = torch.where(m, xa, x1)
    c1 = torch.where(m, 0, c1)
    m = todo2 & (c2 != 0)
    xa = torch.where(c2 == 1, 0, right)
    y2 = torch.where(m, shifted(y2, xa - x2, y2 - y1, x2 - x1, m), y2)
    x2 = torch.where(m, xa, x2)
    c2 = torch.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line_pixels(a: torch.Tensor, b: torch.Tensor, H: int, W: int):
    """Pixels of cv2's 8-connected lines a -> b [L,2] (int64), as
    (line [P], flat pixel [P]): clipped, drawn left to right (endpoints
    swapped when x falls), one pixel per step of the major axis and a
    minor step where Bresenham's error goes negative; after k steps the
    minor offset is floor((2 dmin k + dmaj - 1) / (2 dmaj))."""
    dev = a.device
    x1, y1, x2, y2, inside = _clip_lines(a, b, H, W)
    swap = x2 < x1
    x1, x2 = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
    y1, y2 = torch.where(swap, y2, y1), torch.where(swap, y1, y2)
    ddx, ddy = x2 - x1, (y2 - y1).abs()
    sy = torch.where(y2 < y1, -1, 1)
    vert = ddy > ddx
    dmaj = torch.maximum(ddx, ddy)
    dmin = torch.minimum(ddx, ddy)
    count = torch.where(inside, dmaj + 1, 0)
    line = torch.repeat_interleave(torch.arange(a.shape[0], device=dev),
                                   count)
    start = torch.cumsum(count, 0) - count
    k = torch.arange(line.shape[0], device=dev) - start[line]
    dM, dm = dmaj[line], dmin[line]
    minor = torch.where(dM > 0, torch.div(
        2 * dm * k + dM - 1, torch.clamp(2 * dM, min=1),
        rounding_mode="floor"), 0)
    v = vert[line]
    px = x1[line] + torch.where(v, minor, k)
    py = y1[line] + sy[line] * torch.where(v, k, minor)
    return line, py * W + px


@functools.lru_cache(maxsize=None)
def _disc(radius: int) -> Tuple[Tuple[int, int], ...]:
    """(dy, dx) offsets of the disc cv2.circle(thickness=-1, LINE_8)
    fills at radius r: OpenCV's integer midpoint circle, each step's
    four horizontal runs."""
    cells = set()
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for ry, half in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            for rx in range(-half, half + 1):
                cells.add((ry, rx))
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return tuple(sorted(cells))


def _disc_pixels(centers: torch.Tensor, radius: int, H: int, W: int):
    """Discs of `radius` around integer centers [N,2] (x, y): (center
    [P], flat pixel [P]) for the disc pixels inside the image."""
    off = torch.tensor(_disc(radius), dtype=torch.int64,
                       device=centers.device)              # [S, 2]
    c = centers.to(torch.int64)
    y = c[:, None, 1] + off[None, :, 0]
    x = c[:, None, 0] + off[None, :, 1]
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    idx = torch.arange(c.shape[0], device=c.device)[:, None].expand_as(x)
    return idx[ok], (y * W + x)[ok]


def _draw(buf: torch.Tensor, pix: torch.Tensor, rank: torch.Tensor):
    buf.scatter_reduce_(0, pix, rank, reduce="amax")


def _span_tables(H: int, W: int, device) -> torch.Tensor:
    """[K, H*W] int32 tables, -1 where nothing: entry (k, y*W + x) is
    the highest rank drawn over the whole block [x, x + 2^k) of row y;
    table 0 holds single pixels. 2^(K-1) <= W."""
    return torch.full((W.bit_length(), H * W), -1, dtype=torch.int32,
                      device=device)


def _draw_spans(tab: torch.Tensor, row: torch.Tensor, x0: torch.Tensor,
                x1: torch.Tensor, rank: torch.Tensor):
    """Draw rank over the spans [x0, x1] of the rows starting at flat
    pixel `row`, two updates a span whatever its length: the two
    blocks of length 2^k, k = floor(log2(x1 - x0 + 1)), that start at
    x0 and end at x1 cover it, and a max may count a pixel twice."""
    keep = x1 >= x0
    row, x0, x1, rank = row[keep], x0[keep], x1[keep], rank[keep]
    pow2 = 2 ** torch.arange(tab.shape[0], device=row.device)
    k = torch.searchsorted(pow2, x1 - x0 + 1, right=True) - 1
    flat = tab.view(-1)
    at = k * tab.shape[1] + row
    _draw(flat, at + x0, rank)
    _draw(flat, at + x1 - pow2[k] + 1, rank)


def _push_down(tab: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Fold the block tables into table 0: a block [x, x + 2^k) passes
    its rank to the blocks [x, x + 2^(k-1)) and [x + 2^(k-1), x + 2^k).
    Returns the [H*W] highest rank drawn at each pixel."""
    t = tab.view(tab.shape[0], H, W)
    for k in range(tab.shape[0] - 1, 0, -1):
        h = 1 << (k - 1)
        t[k - 1] = torch.maximum(t[k - 1], t[k])
        t[k - 1, :, h:] = torch.maximum(t[k - 1, :, h:], t[k, :, :-h])
    return tab[0]


def _resolve(buf: torch.Tensor, order: torch.Tensor, colors: torch.Tensor,
             base: torch.Tensor):
    """Pixels [H*W, 3]: colors[order[buf]] where something was drawn
    (buf >= 0), else base; and that coverage."""
    covered = buf >= 0
    if order.shape[0] == 0:
        return base, covered
    win = order[torch.clamp(buf, min=0).long()]
    return torch.where(covered[:, None], colors[win], base), covered


# -- rendering --------------------------------------------------------------

def render_mesh(verts_cam: torch.Tensor, faces, camera: Camera,
                base_color=(1.0, 1.0, 0.9),
                image: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a triangle mesh on verts_cam's device.

    verts_cam [V,3] camera-space vertices, faces [F,3]. Returns
    (rgb float [H,W,3], mask float [H,W,1]). Painter's result: faces
    with every vertex at depth > 1e-4, ordered far to near by a stable
    sort of their mean depth, each filled with its shaded flat colour
    (uint8, as the reference writes it); faces whose rounded bounding
    box lies off the image are culled.
    """
    dev = verts_cam.device
    H, W = camera.height, camera.width
    base = _to_u8(_base(image, camera, dev)).reshape(H * W, 3)
    faces = torch.as_tensor(faces, device=dev).long()
    if faces.shape[0] == 0:
        return base.reshape(H, W, 3).float() / 255.0, torch.zeros(
            (H, W, 1), dtype=torch.float32, device=dev)

    uv, z = camera.project(verts_cam)
    zf = z[faces]                                     # [F,3]
    tri_z = (zf[:, 0] + zf[:, 1] + zf[:, 2]) / 3.0

    a = verts_cam[faces[:, 1]] - verts_cam[faces[:, 0]]
    b = verts_cam[faces[:, 2]] - verts_cam[faces[:, 0]]
    n = torch.linalg.cross(a, b, dim=1)
    n = n / (torch.linalg.vector_norm(n, dim=1, keepdim=True) + 1e-12)
    colors = _to_u8(_shade(n, torch.tensor(base_color, dtype=torch.float32,
                                           device=dev)))

    visible = (zf > 1e-4).all(dim=1)
    order = torch.argsort(-tri_z, stable=True)
    order = order[visible[order]]
    p = torch.round(uv[faces[order]]).long()          # [F',3,2]
    on = ~((p[:, :, 0].max(1).values < 0) | (p[:, :, 0].min(1).values >= W)
           | (p[:, :, 1].max(1).values < 0) | (p[:, :, 1].min(1).values >= H))
    rank = torch.arange(order.shape[0], dtype=torch.int32, device=dev)[on]
    p = p[on]                     # rank still indexes `order`

    # outlines (v2, v0), (v0, v1), (v1, v2), in cv2's drawing order, and
    # fill spans, a bounded number of face-rows and outline pixels at a
    # time (a clipped line has at most max(H, W) + 1 pixels)
    ends = torch.stack([p.roll(1, dims=1), p], 2).reshape(-1, 2, 2)
    outline = torch.clamp((ends[:, 1] - ends[:, 0]).abs().amax(-1),
                          max=max(H, W)) + 1
    cost = torch.cumsum(_span_rows(p, H)[1] + outline.reshape(-1, 3).sum(1),
                        0)
    total = int(cost[-1]) if len(cost) else 0
    cuts = torch.searchsorted(cost, torch.arange(
        CHUNK, max(total, CHUNK), CHUNK, device=dev)).tolist()
    tab = _span_tables(H, W, dev)
    for s, e in zip([0] + cuts, cuts + [len(cost)]):
        if e > s:
            line, pix = _line_pixels(ends[3 * s:3 * e, 0],
                                     ends[3 * s:3 * e, 1], H, W)
            _draw(tab[0], pix, rank[s + line // 3])
            face, y, x0, x1 = _fill_spans(p[s:e], H, W)
            _draw_spans(tab, y * W, x0, x1, rank[s + face])
    out, covered = _resolve(_push_down(tab, H, W), order, colors, base)
    return (out.reshape(H, W, 3).float() / 255.0,
            covered.reshape(H, W, 1).float())


def render_points(pts_cam: torch.Tensor, camera: Camera,
                  colors=None, radius: int = 1,
                  image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Splat a point cloud (world/scene view). Returns rgb [H,W,3].

    radius <= 1: the nearest point wins each pixel (truncated pixel
    coordinates, float colours). radius > 1: the image goes through
    uint8 and each point stamps cv2.circle's filled disc, far to near."""
    dev = pts_cam.device
    H, W = camera.height, camera.width
    rgb = _base(image, camera, dev)
    uv, z = camera.project(pts_cam)
    ok = (z > 1e-4) & (uv[:, 0] >= 0) & (uv[:, 0] < W) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    uv = uv[ok].to(torch.int32)
    z = z[ok]
    if colors is None:
        cols = torch.full((uv.shape[0], 3), 0.6, dtype=torch.float32,
                          device=dev)
    else:
        cols = torch.as_tensor(colors, dtype=torch.float32, device=dev)
        cols = cols.expand(z.shape[0], 3) if cols.ndim == 1 else cols[ok]
    order = torch.argsort(-z, stable=True)
    rank = torch.empty_like(order, dtype=torch.int32)
    rank[order] = torch.arange(order.shape[0], dtype=torch.int32,
                               device=dev)
    # the highest rank drawn at each pixel, -1 where nothing
    buf = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    if radius <= 1:
        _draw(buf, uv[:, 1].long() * W + uv[:, 0].long(), rank)
        return _resolve(buf, order, cols, rgb.reshape(H * W, 3))[0].reshape(
            H, W, 3)
    point, pix = _disc_pixels(uv, radius, H, W)
    _draw(buf, pix, rank[point])
    out, _ = _resolve(buf, order, _to_u8(cols),
                      _to_u8(rgb).reshape(H * W, 3))
    return out.reshape(H, W, 3).float() / 255.0


def composite(render_rgb: torch.Tensor, mask: torch.Tensor,
              background: torch.Tensor) -> torch.Tensor:
    """Alpha-composite the render over a background frame."""
    return render_rgb * mask + (1.0 - mask) * background


def draw_circles(image: torch.Tensor, uv: torch.Tensor, radius: int = 4,
                 color=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """Draw filled keypoint circles of `radius` at round(uv) [N,2]."""
    H, W = image.shape[:2]
    out = _to_u8(image).reshape(H * W, 3)
    if uv.shape[0]:
        _, pix = _disc_pixels(torch.round(uv), radius, H, W)
        c = torch.tensor([int(v * 255) for v in color], dtype=torch.uint8,
                         device=image.device)
        out[pix] = c
    return out.reshape(H, W, 3).float() / 255.0


def rotation_x_180(device=None) -> torch.Tensor:
    """The 180-degree X flip applied to meshes before rendering
    (pyrender camera convention adapter)."""
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[1, 1] = -1.0
    m[2, 2] = -1.0
    return m
