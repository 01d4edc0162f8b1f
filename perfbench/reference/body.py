"""The plain body chain: rotation codecs, the VPoser v1 decoder, the
SMPL-X forward (shape and pose blend shapes, hand PCA, the whole
55-joint kinematic chain composed joint by joint, linear blend
skinning) and the body-to-world transform of the clip solve.

Written from the published models (SMPL-X, Pavlakos et al., CVPR 2019;
VPoser v1, the same paper) and the clip solve's parameter layout; no
joint or pose pruning, no cached tables, no fused products. Every
product goes through ``prec`` so the control can run it in TF32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from perfbench.inputs.synth import NUM_JOINTS, PARENTS
from perfbench.reference.prec import einsum, mm

# the 78-d optimization layout: transl, global orient (6D), betas,
# VPoser latent, left and right hand PCA, camera pivot
SLICES_6D = {"transl": (0, 3), "global_orient": (3, 9), "betas": (9, 19),
             "body_pose": (19, 51), "left_hand_pose": (51, 63),
             "right_hand_pose": (63, 75), "camera_translation": (75, 78)}
BODY_JOINTS = 23          # the joints the solve's priors read


def absv(x: torch.Tensor) -> torch.Tensor:
    """|x|, differentiated as +1 at 0 (the solve's convention)."""
    return torch.where(x >= 0, x, -x)


def aa_to_matrot(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3], series near 0."""
    t2 = torch.sum(aa * aa, dim=-1)
    small = t2 < 1e-8
    safe = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(safe)
    s = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    c = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / safe)
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    o = torch.zeros_like(x)
    K = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                     torch.stack([-y, x, o], -1)], -2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s[..., None, None] * K + c[..., None, None] * mm(K, K)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return torch.where(small, torch.zeros_like(v), v / n)


def rot6d_to_matrot(r6: torch.Tensor) -> torch.Tensor:
    """6D (first two columns, row-major) -> [..., 3, 3], Gram-Schmidt."""
    m = r6.reshape(r6.shape[:-1] + (3, 2))
    b1 = _normalize(m[..., 0])
    a2 = m[..., 1]
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -1)


def params_to_6d(x: torch.Tensor) -> torch.Tensor:
    """[..., 75] (axis-angle orient) -> [..., 78] (6D orient)."""
    R = aa_to_matrot(x[..., 3:6])
    return torch.cat([x[..., :3], R[..., :, :2].reshape(R.shape[:-2] + (6,)),
                      x[..., 6:]], dim=-1)


def vposer_decode(w: Dict[str, torch.Tensor], z: torch.Tensor
                  ) -> torch.Tensor:
    """latent [T, 32] -> body joint rotations [T, 21, 3, 3]."""
    def leaky(x):
        return torch.where(x >= 0, x, 0.2 * x)
    h = leaky(mm(z, w["w1"]) + w["b1"])
    h = leaky(mm(h, w["w2"]) + w["b2"])
    r6 = mm(h, w["w3"]) + w["b3"]
    return rot6d_to_matrot(r6.reshape(r6.shape[0], -1, 6))


class Body:
    """The SMPL-X forward over the session's tables and VPoser weights
    (``perfbench.inputs.synth``); jaw, eyes and expression at zero, as
    the clip solve leaves them."""

    def __init__(self, tables: Dict[str, torch.Tensor],
                 vposer: Dict[str, torch.Tensor]):
        self.t = tables
        self.vp = vposer
        self._jtabs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def num_verts(self) -> int:
        return self.t["v_template"].shape[0]

    def _joint_tables(self):
        """(rest joints of the template [55, 3], their shape directions
        [55, 3, betas]): the joint regressor applied once per precision."""
        from perfbench.reference.prec import _MODE
        key = _MODE[0]
        if key not in self._jtabs:
            with torch.no_grad():
                jr = self.t["j_regressor"]
                self._jtabs[key] = (
                    mm(jr, self.t["v_template"]),
                    einsum("jv,vcs->jcs", jr, self.t["shapedirs"]))
        return self._jtabs[key]

    def forward(self, betas, orient_R, body_R, transl, lhand, rhand,
                vids: Optional[torch.Tensor], with_verts: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """-> (vertices [T, n, 3] of `vids` (all when None; None without
        `with_verts`), posed joints [T, 55, 3]), both translated by
        `transl`."""
        t = self.t
        T = betas.shape[0]
        dev = betas.device
        eye = torch.eye(3, device=dev)
        hands = torch.cat([
            mm(lhand, t["hands_components_l"]) + t["hands_mean_l"],
            mm(rhand, t["hands_components_r"]) + t["hands_mean_r"]], -1)
        hand_R = aa_to_matrot(hands.reshape(T, 30, 3))
        R = torch.cat([orient_R[:, None], body_R,
                       eye.expand(T, 3, 3, 3), hand_R], dim=1)   # [T,55,3,3]
        j_tmpl, j_dirs = self._joint_tables()
        J = j_tmpl + einsum("jcs,ts->tjc", j_dirs, betas)        # [T,55,3]
        G = self._chain(R, J)                                     # [T,55,4,4]
        posed = G[..., :3, 3]
        if not with_verts:
            return None, posed + transl[:, None]
        if vids is None:
            tmpl, dirs, pd, w = (t["v_template"], t["shapedirs"],
                                 t["posedirs"], t["lbs_weights"])
        else:
            cols = (vids[:, None] * 3
                    + torch.arange(3, device=dev)).reshape(-1)
            tmpl, dirs = t["v_template"][vids], t["shapedirs"][vids]
            pd, w = t["posedirs"][:, cols], t["lbs_weights"][vids]
        n = tmpl.shape[0]
        v_shaped = tmpl + einsum("vcs,ts->tvc", dirs, betas)
        pose_feat = (R[:, 1:] - eye).reshape(T, (NUM_JOINTS - 1) * 9)
        v_posed = v_shaped + mm(pose_feat, pd).reshape(T, n, 3)
        corr = einsum("tjpq,tjq->tjp", G[..., :3, :3], J)
        A = torch.cat([G[..., :3, :3], (posed - corr)[..., None]], -1)
        Tv = einsum("vj,tjk->tvk", w, A.reshape(T, NUM_JOINTS, 12))
        v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
        verts = einsum("tvpq,tvq->tvp", Tv.reshape(T, n, 3, 4), v_h)
        return verts + transl[:, None], posed + transl[:, None]

    @staticmethod
    def _chain(R: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
        """Forward kinematics, one joint at a time down the tree: world
        transforms [T, 55, 4, 4] of rotations R and rest joints J."""
        T = R.shape[0]
        bottom = torch.zeros(T, 1, 4, device=R.device)
        bottom[..., 3] = 1.0
        G = []
        for j, p in enumerate(PARENTS):
            off = J[:, j] if p < 0 else J[:, j] - J[:, p]
            local = torch.cat([torch.cat([R[:, j], off[..., None]], -1),
                               bottom], -2)
            G.append(local if p < 0 else mm(G[p], local))
        return torch.stack(G, dim=1)


def transform_points(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """[T, 4, 4] applied to [T, n, 3]."""
    h = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return mm(h, mat.transpose(-1, -2))[..., :3]


def forward_world(body: Body, body_6d, scale, camera_ext,
                  vids: Optional[torch.Tensor], with_verts: bool = True
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """State -> (world vertices [T, n, 3] of `vids`, scaled then placed;
    world body joints [T, 23, 3], placed unscaled)."""
    d = {k: body_6d[:, a:b] for k, (a, b) in SLICES_6D.items()}
    verts, joints = body.forward(
        d["betas"], rot6d_to_matrot(d["global_orient"]),
        vposer_decode(body.vp, d["body_pose"]), d["transl"],
        d["left_hand_pose"], d["right_hand_pose"], vids, with_verts)
    T = body_6d.shape[0]
    move = torch.eye(4, device=body_6d.device).repeat(T, 1, 1)
    move = torch.cat([move[:, :3, :3],
                      (d["camera_translation"] * scale)[..., None]], -1)
    move = torch.cat([move, torch.eye(4, device=body_6d.device)[3:]
                      .expand(T, 1, 4)], -2)
    b2w = mm(camera_ext, move)
    joints_w = transform_points(joints[:, :BODY_JOINTS], b2w)
    verts_w = (transform_points(verts * scale, b2w) if with_verts else None)
    return verts_w, joints_w
