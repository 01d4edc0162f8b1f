"""Seeded inputs of the clip-solve cells, made on the device.

One capture session per run: one SMPL-X-shaped body model, one VPoser
decoder, one scene cloud and a stream of clips (each clip its own body
parameters [T, 75] and camera trajectory [T, 4, 4]), all drawn from one
``torch.Generator`` on the run's device in a few large calls, so the
same seed gives the same inputs and no two seeds differ in any size.

The draws follow the port's synthetic stand-ins at the commit this
benchmark was written against (cc31d8d): ``fpv4d_torch/models/smplx.py``
``synthetic_arrays(sparse_weights=True)`` and ``_synthetic_rest_joints``,
``fpv4d_torch/models/vposer.py`` ``random_params``,
``fpv4d_torch/ops/contact.py`` ``synthetic_segments(coherent=True)`` and
the clip and scene draws of ``fpv4d_torch/utils/bench_problem.py``
``standard_problem``. The constants are copied here, so a change to the
program does not change the inputs. Three departures keep every seed's
sizes equal (the port's stand-ins draw them):

* each vertex's generating bone is a random order of a fixed multiset
  (at V = 10,475 every bone 193 or 194 vertices), so each leg's three
  bones generate 582 vertices and its contact set is int(0.7 * 582) =
  407 of them, 814 a frame (``segments``);
* the scene's height noise is clipped to 3 sigma, so the voxel grid's
  dims are the same for every seed;
* the draws come from torch's generator, not numpy's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

NUM_JOINTS = 55
PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)
# bones whose vertices make each contact part (ops/contact.py)
PART_BONES = {"L_Leg": (4, 7, 10), "R_Leg": (5, 8, 11)}

_REST_BODY = np.array([
    [0.00, 0.00, 0.00], [0.09, -0.07, 0.00], [-0.09, -0.07, 0.00],
    [0.00, 0.12, 0.00], [0.10, -0.48, 0.00], [-0.10, -0.48, 0.00],
    [0.00, 0.25, 0.00], [0.10, -0.88, -0.02], [-0.10, -0.88, -0.02],
    [0.00, 0.32, 0.00], [0.11, -0.94, 0.10], [-0.11, -0.94, 0.10],
    [0.00, 0.48, 0.00], [0.07, 0.42, 0.00], [-0.07, 0.42, 0.00],
    [0.00, 0.58, 0.02], [0.17, 0.44, 0.00], [-0.17, 0.44, 0.00],
    [0.43, 0.42, 0.00], [-0.43, 0.42, 0.00], [0.68, 0.42, 0.00],
    [-0.68, 0.42, 0.00], [0.00, 0.60, 0.06], [0.03, 0.65, 0.08],
    [-0.03, 0.65, 0.08],
], dtype=np.float32)


def rest_joints() -> np.ndarray:
    """[55, 3] rest skeleton: the body's 25 joints and five three-link
    fingers off each wrist."""
    joints = np.zeros((NUM_JOINTS, 3), dtype=np.float32)
    joints[:25] = _REST_BODY
    for side, wrist, sgn in (("l", 20, 1.0), ("r", 21, -1.0)):
        base = 25 if side == "l" else 40
        for f in range(5):
            z = (f - 2) * 0.018
            for k in range(3):
                joints[base + f * 3 + k] = joints[wrist] + np.array(
                    [sgn * (0.05 + 0.025 * (k + 1)), -0.01 * f, z],
                    dtype=np.float32)
    return joints


def tree_hops() -> np.ndarray:
    """[55, 55] hop distance over the kinematic tree."""
    J = len(PARENTS)
    adj = [[] for _ in range(J)]
    for j in range(1, J):
        adj[j].append(PARENTS[j])
        adj[PARENTS[j]].append(j)
    hops = np.full((J, J), J, np.int64)
    for s in range(J):
        hops[s, s] = 0
        queue = [s]
        while queue:
            nxt = []
            for u in queue:
                for v in adj[u]:
                    if hops[s, v] > hops[s, u] + 1:
                        hops[s, v] = hops[s, u] + 1
                        nxt.append(v)
            queue = nxt
    return hops


@dataclass
class Session:
    """What one run solves: the model's tables (``SmplxModel``'s
    keyword arguments, on the device), the VPoser weights, the scene
    [M, 3], the contact vertex ids of each leg, and the clip stream
    (bodies [C, T, 75], cameras [C, T, 4, 4])."""
    model: Dict[str, torch.Tensor]
    vposer: Dict[str, torch.Tensor]
    scene: torch.Tensor
    vids_left: torch.Tensor
    vids_right: torch.Tensor
    bodies: torch.Tensor
    cams: torch.Tensor


def model_tables(gen: torch.Generator, num_verts: int, num_betas: int,
                 num_expr: int, num_pca: int, device
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The body model's tables (sparse top-4 skinning, a joint regressor
    over each joint's nearest vertices, Gaussian blend shapes) and each
    vertex's generating bone [V]."""
    V, J = num_verts, NUM_JOINTS
    rest = torch.as_tensor(rest_joints(), device=device)
    par = torch.as_tensor(np.maximum(np.asarray(PARENTS), 0), device=device)
    perm = torch.randperm(V, generator=gen, device=device)
    bone = 1 + (torch.arange(V, device=device) % (J - 1))[perm]
    t = torch.rand((V, 1), generator=gen, device=device)
    verts = rest[bone] * t + rest[par[bone]] * (1 - t)
    verts = verts + torch.randn((V, 3), generator=gen, device=device) * 0.04
    d2 = ((verts[:, None, :] - rest[None, :, :]) ** 2).sum(-1)    # [V, J]
    w = torch.exp(-d2 / (2 * 0.05 ** 2))
    w = w / (w.sum(1, keepdim=True) + 1e-12)
    hops = torch.as_tensor(tree_hops(), device=device)
    local = (hops[bone] <= 2) | (hops[par[bone]] <= 2)
    w_m = torch.where(local, w, torch.zeros_like(w))
    top = torch.topk(w_m, 4, dim=1).indices
    w_s = torch.zeros_like(w).scatter_(1, top, w_m.gather(1, top))
    w = w_s / (w_s.sum(1, keepdim=True) + 1e-12)
    k = max(4, V // 256)
    near = torch.topk(d2, k, dim=0, largest=False).indices       # [k, J]
    jreg = torch.zeros((J, V), device=device).scatter_(
        1, near.T.contiguous(), 1.0 / k)

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    tables = dict(
        v_template=verts, shapedirs=randn(V, 3, num_betas, scale=0.01),
        exprdirs=randn(V, 3, num_expr, scale=0.002),
        posedirs=randn((J - 1) * 9, V * 3, scale=0.001),
        j_regressor=jreg, lbs_weights=w,
        hands_components_l=randn(num_pca, 45, scale=0.1),
        hands_components_r=randn(num_pca, 45, scale=0.1),
        hands_mean_l=randn(45, scale=0.05),
        hands_mean_r=randn(45, scale=0.05),
        faces=torch.randint(0, V, (max(1, 2 * V - 4), 3), generator=gen,
                            device=device, dtype=torch.int32))
    return tables, bone


def vposer_weights(gen: torch.Generator, latent: int, hidden: int,
                   joints: int, device) -> Dict[str, torch.Tensor]:
    """VPoser v1's decoder (latent -> hidden -> hidden -> joints * 6),
    weights [in, out] scaled by 1/sqrt(fan_in), the last by 0.05 more,
    and the output bias at identity rotations."""
    def lin(fan_in, fan_out, s):
        w = torch.randn((fan_in, fan_out), generator=gen, device=device)
        return w * (s / math.sqrt(fan_in)), torch.zeros(fan_out,
                                                        device=device)

    w1, b1 = lin(latent, hidden, 1.0)
    w2, b2 = lin(hidden, hidden, 1.0)
    w3, b3 = lin(hidden, joints * 6, 0.05)
    ident6 = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], device=device)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3,
            "b3": b3 + ident6.repeat(joints)}


def segments(gen: torch.Generator, bone: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each leg's contact vertices: int(0.7 n) of the n vertices that its
    bones generate, drawn without replacement, sorted."""
    out = []
    for part in ("L_Leg", "R_Leg"):
        ids = torch.nonzero(torch.isin(bone, torch.tensor(
            PART_BONES[part], device=bone.device))).flatten()
        keep = max(8, int(0.7 * ids.numel()))
        pick = torch.randperm(ids.numel(), generator=gen,
                              device=bone.device)[:keep]
        out.append(torch.sort(ids[pick]).values)
    return out[0], out[1]


def floor_scene(gen: torch.Generator, points: int, device) -> torch.Tensor:
    """A 10 m x 10 m floor of g x g points (g = isqrt(points)) at
    height -1 with 5 cm height noise (clipped at 3 sigma)."""
    g = math.isqrt(points)
    lin = torch.linspace(-5.0, 5.0, g, device=device)
    zs, xs = torch.meshgrid(lin, lin, indexing="ij")
    noise = torch.randn((g * g,), generator=gen, device=device).clamp(-3, 3)
    return torch.stack([xs.reshape(-1), -1.0 + 0.05 * noise,
                        zs.reshape(-1)], 1)


def _smooth_noise(gen, clips, n, dim, scale, device):
    """[clips, n, dim] box-filtered (11 taps) Gaussian noise."""
    k = 11
    x = torch.randn((clips, n + k - 1, dim), generator=gen, device=device)
    c = torch.cumsum(torch.nn.functional.pad(x, (0, 0, 1, 0)), dim=1)
    return (c[:, k:] - c[:, :-k]) / k * scale


def clip_stream(gen: torch.Generator, clips: int, T: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`clips` clips of packed body parameters [C, T, 75] (smooth
    translation, orientation, pose latent, hands and camera pivot;
    one shape per clip) and world-from-camera poses [C, T, 4, 4]
    (identity rotation, smooth translation)."""
    body = torch.zeros((clips, T, 75), device=device)
    body[..., 0:3] = _smooth_noise(gen, clips, T, 3, 0.3, device)
    body[..., 3:6] = _smooth_noise(gen, clips, T, 3, 0.2, device)
    body[..., 6:16] = (torch.randn((clips, 1, 10), generator=gen,
                                   device=device) * 0.3)
    body[..., 16:48] = _smooth_noise(gen, clips, T, 32, 0.5, device)
    body[..., 48:75] = _smooth_noise(gen, clips, T, 27, 0.2, device)
    cam = torch.eye(4, device=device).repeat(clips, T, 1, 1)
    cam[..., :3, 3] = _smooth_noise(gen, clips, T, 3, 0.5, device)
    return body, cam


def session(seed: int, cfg: dict, clips: int, device) -> Session:
    """Every input of one run, from `seed` and the configuration's
    sizes (``num_verts``, ``num_betas``, ``num_expressions``,
    ``num_hand_pca``, the VPoser widths, ``scene_points``, ``frames``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tables, bone = model_tables(gen, cfg["num_verts"], cfg["num_betas"],
                                cfg["num_expressions"], cfg["num_hand_pca"],
                                device)
    vp = vposer_weights(gen, cfg["vposer_latent"], cfg["vposer_hidden"],
                        cfg["vposer_joints"], device)
    left, right = segments(gen, bone)
    scene = floor_scene(gen, cfg["scene_points"], device)
    bodies, cams = clip_stream(gen, clips, cfg["frames"], device)
    return Session(model=tables, vposer=vp, scene=scene, vids_left=left,
                   vids_right=right, bodies=bodies, cams=cams)
