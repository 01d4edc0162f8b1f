"""The clip solve's objective, its Adam and its phase starts, in plain
PyTorch: what the reference puts beside each phase of a solve.

A phase's loss (the configuration's stage recipes):

  local_a   0.2 contact + smooth + rec          (body, scale)
  local_b   rec + 0.5 smooth                    (body, camera)
  skate     vert_smooth + smooth + rec + skate  (body)
  global_a  0.1 contact + smooth + rec          (body, scale)
  global_b  rec + world_smooth + 0.5 smooth     (body, camera)
  dct_a     10 dct, on joints computed once     (c_dct)
  dct_b     1e-4 dct + 0.5 rec + 0.1 contact    (body, scale)

with rec the frame-weighted L1 to the initial parameters, smooth the L1
of their second differences, contact 0.1 mean(r / (r + 1)) with r =
sqrt(d + 1e-4) of the contact vertices' squared nearest distance,
world_smooth the L1 of the world joints' first differences, dct the
mean over windows of sum_t e / (e + 1), e the squared residual of the
joints' trajectory to its DCT coefficients, and skate the planted-foot
L1 of each foot's frame differences. One Adam (optax's order) over the
four leaves (body [T, 78], scale, camera [T, 4, 4], c_dct) runs through
every phase; a phase's other leaves get zero gradients and move on
their moments.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import contact as C
from perfbench.reference.body import Body, absv, forward_world, params_to_6d
from perfbench.reference.prec import einsum

LEAVES = ("body_6d", "scale", "camera_ext", "c_dct")
MASKS = {"local_a": ("body_6d", "scale"), "local_b": ("body_6d", "camera_ext"),
         "global_a": ("body_6d", "scale"),
         "global_b": ("body_6d", "camera_ext"), "dct_a": ("c_dct",),
         "dct_b": ("body_6d", "scale"), "skate": ("body_6d",)}
CONTACT_PHASES = ("local_a", "global_a", "dct_b")


def rec_l1(target, body, fw):
    return torch.mean(absv(target - body) * fw[:, None])


def smooth2(seq):
    d = seq[:-1] - seq[1:]
    return torch.mean(absv(d[:-1] - d[1:]))


def smooth1(seq):
    return torch.mean(absv(seq[:-1] - seq[1:]))


def robust(d2):
    r = torch.sqrt(d2 + 1e-4)
    return torch.mean(r / (r + 1.0))


def dct_basis(n: int, k: int, device) -> torch.Tensor:
    t = np.arange(n)[:, None]
    f = np.arange(k)[None, :]
    b = np.cos(np.pi * (2 * t + 1) * f / (2 * n)) * np.sqrt(2.0 / n)
    b[:, 0] /= np.sqrt(2.0)
    return torch.as_tensor(b.astype(np.float32), device=device)


def dct_term(joints_w, c_dct, window):
    W, J, _, K = c_dct.shape
    traj = joints_w[:, :J].reshape(W, window, J, 3)
    rec = einsum("tk,wjak->wtja", dct_basis(window, K, joints_w.device),
                 c_dct)
    e = (traj - rec) ** 2
    return torch.mean(torch.sum(e / (e + 1.0), dim=1))


def foot_skate(left, right, w_right):
    w_r = torch.where(w_right < 0.5, 0.0, w_right)
    w_l_full = 1.0 - w_right
    w_l = torch.where(w_l_full < 0.5, 0.0, w_l_full)
    dl = left[:-1] - left[1:]
    dr = right[:-1] - right[1:]
    return (torch.mean(absv(dl * w_l[1:, None, None]))
            + torch.mean(absv(dr * w_r[1:, None, None])))


class Adam:
    """optax.adam over the four leaves; its state is the moments (per
    leaf) and one step count."""

    def __init__(self, leaves: List[torch.Tensor], lr: float,
                 mu=None, nu=None, count: int = 0):
        self.leaves, self.lr = leaves, lr
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.mu = mu or [torch.zeros_like(p) for p in leaves]
        self.nu = nu or [torch.zeros_like(p) for p in leaves]
        self.count = count

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        self.count += 1
        dev = self.leaves[0].device
        n = torch.tensor(self.count, dtype=torch.int32, device=dev)
        bc1 = 1 - torch.pow(self.b1, n)
        bc2 = 1 - torch.pow(self.b2, n)
        for p, g, m, v in zip(self.leaves, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_((g * g) * (1 - self.b2))
            den = torch.sqrt(v / bc2) + self.eps
            p.add_((m / bc1) / den * (-self.lr))


class Problem:
    """One configuration's solve over one session's inputs, in plain
    PyTorch: the phase losses, the initial state, the contact sources
    (candidate tables, the grid, or the whole scene) and the planted-foot
    detection, each worked out from the session's inputs."""

    def __init__(self, cfg: dict, session, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.body = Body({k: v.to(self.device) for k, v in
                          session.model.items()},
                         {k: v.to(self.device) for k, v in
                          session.vposer.items()})
        self.scene = session.scene.to(self.device)
        self.left = session.vids_left.to(self.device)
        self.right = session.vids_right.to(self.device)
        self.vids = torch.cat([self.left, self.right])
        self.grid = None
        if cfg["nn_impl"] == "grid":
            self.grid = C.build_grid(self.scene.cpu().numpy(), cfg["grid_h"],
                                     cfg["grid_slots"], cfg["grid_max_cells"],
                                     self.device)
        self._skate_sets()

    def _skate_sets(self):
        """The anti-skate vertex set: a stratified sample of the
        vertices skinned by the body's 23 joints alone, with both feet."""
        n_sub = self.cfg["skate_subset"]
        V = self.body.num_verts
        left = self.left.cpu().numpy()
        right = self.right.cpu().numpy()
        if n_sub and n_sub < V:
            pool = np.arange(V, dtype=np.int64)
            if self.cfg["skate_body_only"]:
                w = self.body.t["lbs_weights"].cpu().numpy()
                ok = (w[:, 23:] == 0).all(axis=1)
                if ok.any():
                    pool = pool[ok]
            strat = pool[np.linspace(0, len(pool) - 1, min(n_sub, len(pool)),
                                     dtype=np.int64)]
            vids = np.unique(np.concatenate([strat, left, right]))
            pos = {int(v): i for i, v in enumerate(vids)}
            sl = [pos[int(v)] for v in left]
            sr = [pos[int(v)] for v in right]
            self.skate_vids = torch.as_tensor(vids, device=self.device)
        else:
            sl, sr = left, right
            self.skate_vids = None
        self.skate_left = torch.as_tensor(np.asarray(sl, np.int64),
                                          device=self.device)
        self.skate_right = torch.as_tensor(np.asarray(sr, np.int64),
                                           device=self.device)

    # -- start of a solve ------------------------------------------------
    @torch.no_grad()
    def init(self, body_75, cam) -> Dict[str, torch.Tensor]:
        """The initial state and the targets: frames whose VPoser latent
        energy exceeds outlier_factor x the mean get weight 0 and start
        from the nearest good frame (the earlier on ties)."""
        cfg = self.cfg
        x = body_75.to(self.device, torch.float32)
        T = x.shape[0]
        b6 = params_to_6d(x)
        stats = torch.sum(x[:, 16:48] ** 2, dim=1)
        good = stats <= cfg["outlier_factor"] * torch.mean(stats)
        idx = torch.arange(T, device=self.device)
        dist = (torch.abs(idx[:, None] - idx[None, :])
                + torch.where(good[None, :], 0, 10 * T))
        src = torch.where(good, idx, torch.argmin(dist, dim=1))
        return {"body_6d": b6[src].clone(),
                "scale": torch.tensor(cfg["scale_init"], device=self.device),
                "camera_ext": cam.to(self.device, torch.float32).clone(),
                "c_dct": torch.zeros((T // cfg["window"], 23, 3,
                                      cfg["dct_num"]), device=self.device),
                "target": b6, "fw": good.to(torch.float32)}

    # -- contact -----------------------------------------------------------
    def contact_source(self, state) -> Optional[tuple]:
        """The tables a contact phase's steps read, made at the phase's
        start (None where each step searches the whole scene)."""
        if self.cfg["nn_impl"] != "grid":
            return None
        with torch.no_grad():
            vw, _ = forward_world(self.body, state["body_6d"],
                                  state["scale"], state["camera_ext"],
                                  self.vids)
            return C.frame_tables(self.grid, vw, self.cfg["cell_budget"],
                                  self.cfg["compact"])

    def nn(self, pts, tables) -> torch.Tensor:
        if tables is not None:
            return C.nn_tables(pts, *tables)
        if self.cfg["nn_impl"] == "grid":
            return C.nn_grid(self.grid, pts)
        return C.nn_scene(pts, self.scene)

    @torch.no_grad()
    def detect(self, state) -> torch.Tensor:
        """Per-frame planted-foot weight left / (left + right) of the
        feet's mean distance to the scene (the grid's cell slots, or the
        whole scene)."""
        vw, _ = forward_world(self.body, state["body_6d"], state["scale"],
                              state["camera_ext"], self.vids)
        n = self.left.numel()
        dl = torch.mean(self.nn(vw[:, :n], None), dim=1)
        dr = torch.mean(self.nn(vw[:, n:], None), dim=1)
        return dl / (dl + dr + 1e-12)

    # -- phases --------------------------------------------------------------
    def loss(self, phase: str, st, target, fw, tables=None,
             weight_right=None, joints_fixed=None, nn=None) -> torch.Tensor:
        """The phase's loss at state `st` (a dict of the four leaves)."""
        cfg = self.cfg
        nn = nn or self.nn
        rec = rec_l1(target, st["body_6d"], fw)
        smooth = smooth2(st["body_6d"])
        if phase == "local_b":
            return rec + smooth * 0.5
        if phase == "dct_a":
            return dct_term(joints_fixed, st["c_dct"], cfg["window"]) * 10.0
        if phase == "skate":
            vw, _ = forward_world(self.body, st["body_6d"], st["scale"],
                                  st["camera_ext"], self.skate_vids)
            return (smooth2(vw) + smooth + rec
                    + foot_skate(vw[:, self.skate_left],
                                 vw[:, self.skate_right], weight_right))
        vw, jw = forward_world(self.body, st["body_6d"], st["scale"],
                               st["camera_ext"], self.vids,
                               with_verts=phase != "global_b")
        if phase == "global_b":
            return rec + smooth1(jw) + smooth * 0.5
        contact = 0.1 * robust(nn(vw, tables))
        if phase == "local_a":
            return contact * 0.2 + smooth + rec
        if phase == "global_a":
            return contact * 0.1 + smooth + rec
        if phase == "dct_b":
            return (dct_term(jw, st["c_dct"], cfg["window"]) * 1e-4
                    + rec * 0.5 + contact * 0.1)
        raise ValueError(f"unknown phase {phase!r}")

    def follow(self, phase: str, state: Dict[str, torch.Tensor],
               adam: Adam, target, fw, steps: int,
               weight_right=None) -> List[float]:
        """`steps` Adam steps of `phase` from `state` (its tensors are
        the Adam's leaves, updated in place) -> the loss before each."""
        tables = (self.contact_source(state) if phase in CONTACT_PHASES
                  else None)
        joints = None
        if phase == "dct_a":
            with torch.no_grad():
                _, joints = forward_world(self.body, state["body_6d"],
                                          state["scale"],
                                          state["camera_ext"], self.vids,
                                          with_verts=False)
        out = []
        for _ in range(steps):
            st = {k: (state[k] if k in MASKS[phase] else state[k].detach())
                  for k in LEAVES}
            loss = self.loss(phase, st, target, fw, tables, weight_right,
                             joints)
            wrt = [state[k] for k in MASKS[phase]]
            gs = torch.autograd.grad(loss, wrt, allow_unused=True)
            by = dict(zip(MASKS[phase], gs))
            grads = [by.get(k) if by.get(k) is not None
                     else torch.zeros_like(state[k]) for k in LEAVES]
            out.append(float(loss.detach()))
            adam.step(grads)
        return out


def leaves_of(st: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The state's four leaves as fresh tensors that require grad."""
    return [st[k].detach().clone().requires_grad_(True) for k in LEAVES]


def relative_gap(program: Sequence[float], reference: Sequence[float]
                 ) -> float:
    """max_k |program_k - reference_k| / |reference_k|; inf where either
    is not finite or a value is missing."""
    if len(program) < len(reference):
        return math.inf
    gap = 0.0
    for p, r in zip(program, reference):
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        gap = max(gap, abs(p - r) / max(abs(r), 1e-30))
    return gap
