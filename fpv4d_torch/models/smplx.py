"""SMPL-X body model as a torch ``nn.Module`` (port of
fpv4d/models/smplx.py).

Shape and expression blendshapes, pose-corrective blendshapes, hand
PCA, the 55-joint kinematic chain (level-sweep FK, models/fk.py) and
linear blend skinning, batched over a leading frame axis. The model
tables are registered buffers; ``faces`` and the landmark embedding
stay host numpy arrays.

Loop-invariant tables (the joint regressor composed with the
blendshapes, and the per-subset gathered skinning tables) are built
once per (subset, device) and cached on the instance: the reference
leaves that hoisting to XLA, and eager PyTorch has no such pass.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fpv4d_torch.core.rotations import aa_to_matrot
from fpv4d_torch.models import fk

NUM_JOINTS = 55
NUM_BODY_JOINTS = 21
PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 15, 15, 15,
    # left hand: index, middle, pinky, ring, thumb (3 links each)
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    # right hand
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
)


def _key(a) -> Optional[bytes]:
    return None if a is None else np.asarray(a, np.int64).tobytes()


class SmplxModel(nn.Module):
    """SMPL-X model tables as buffers + the batched forward."""

    # the reference's pytree leaves (models/smplx.py:95), in order
    LEAVES = ("v_template", "shapedirs", "exprdirs", "posedirs",
              "j_regressor", "lbs_weights", "hands_components_l",
              "hands_components_r", "hands_mean_l", "hands_mean_r")

    def __init__(self, v_template, shapedirs, exprdirs, posedirs,
                 j_regressor, lbs_weights, hands_components_l,
                 hands_components_r, hands_mean_l, hands_mean_r,
                 faces, flat_hand_mean: bool = False,
                 lmk_faces_idx=None, lmk_bary_coords=None,
                 device="cpu"):
        super().__init__()
        tables = dict(v_template=v_template, shapedirs=shapedirs,
                      exprdirs=exprdirs, posedirs=posedirs,
                      j_regressor=j_regressor, lbs_weights=lbs_weights,
                      hands_components_l=hands_components_l,
                      hands_components_r=hands_components_r,
                      hands_mean_l=hands_mean_l, hands_mean_r=hands_mean_r)
        for k in self.LEAVES:
            self.register_buffer(k, torch.tensor(
                np.asarray(tables[k], np.float32), device=device))
        self.faces = np.asarray(faces, np.int32)
        self.flat_hand_mean = flat_hand_mean
        self.lmk_faces_idx = lmk_faces_idx
        self.lmk_bary_coords = lmk_bary_coords
        self._cache: Dict[tuple, dict] = {}

    # -- sizes ---------------------------------------------------------------
    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_expr(self) -> int:
        return self.exprdirs.shape[-1]

    @property
    def num_pca(self) -> int:
        return self.hands_components_l.shape[0]

    def landmark_vertex_subset(self):
        """Static (vertex_subset, tri_local [L,3], bary [L,3]) for
        computing the face landmarks from a subset-skinned mesh:
        landmarks = sum_k bary[:, k] * verts[:, tri_local[:, k]]; None
        when the model has no landmark embedding."""
        if self.lmk_faces_idx is None:
            return None
        tris = self.faces[np.asarray(self.lmk_faces_idx)]     # [L, 3]
        vids = np.unique(tris.ravel()).astype(np.int32)
        tri_local = np.searchsorted(vids, tris).astype(np.int32)
        return vids, tri_local, np.asarray(self.lmk_bary_coords,
                                           np.float32)

    # -- static joint-support analysis (host numpy) --------------------------
    def joint_support(self, vertex_subset
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Exact static support of a vertex subset over the joint set:
        (joint_subset, pose_joint_subset) for forward(), or None when
        nothing prunes. joint_subset is the ancestor-closed set of
        joints with nonzero LBS weight over the subset (None when that
        is all 55); pose_joint_subset the joints whose pose-blendshape
        rows are nonzero over the subset's columns (None when all)."""
        sub = np.asarray(vertex_subset)
        w = self.lbs_weights.detach().cpu().numpy()
        w_nz = (w[sub] != 0).any(axis=0)
        kept = set(int(j) for j in np.where(w_nz)[0]) | {0}
        for j in list(kept):                       # ancestor closure
            while PARENTS[j] >= 0:
                j = PARENTS[j]
                kept.add(j)
        kept = np.asarray(sorted(kept), np.int32)
        cols = (sub[:, None] * 3 + np.arange(3)).reshape(-1)
        pd = self.posedirs.detach().cpu().numpy()[:, cols]
        pd_nz = np.abs(pd).reshape(NUM_JOINTS - 1, -1).max(axis=1) > 0
        pose_joints = (1 + np.where(pd_nz)[0]).astype(np.int32)
        pose_sub = (pose_joints if len(pose_joints) < NUM_JOINTS - 1
                    else None)
        joint_sub = kept if len(kept) < NUM_JOINTS else None
        if joint_sub is None and pose_sub is None:
            return None
        return joint_sub, pose_sub

    # -- loop-invariant tables -----------------------------------------------
    def _tables(self, vertex_subset, joint_subset, pose_joint_subset):
        """Per-(subset, device) skinning tables, built once."""
        dev = self.v_template.device
        key = (str(dev), _key(vertex_subset), _key(joint_subset),
               _key(pose_joint_subset))
        tab = self._cache.get(key)
        if tab is not None:
            return tab
        with torch.no_grad():
            dirs = torch.cat([self.shapedirs, self.exprdirs], dim=-1)
            j_template = self.j_regressor @ self.v_template        # [J,3]
            j_dirs = torch.einsum("jv,vcs->sjc", self.j_regressor,
                                  dirs).reshape(dirs.shape[-1], -1)
            if vertex_subset is not None:
                sub = torch.as_tensor(np.asarray(vertex_subset, np.int64),
                                      device=dev)
                cols = (sub[:, None] * 3
                        + torch.arange(3, device=dev)).reshape(-1)
                template = self.v_template[sub]
                dirs_sub = dirs[sub]
                posedirs = self.posedirs[:, cols]
                lbs_weights = self.lbs_weights[sub]
            else:
                template, dirs_sub = self.v_template, dirs
                posedirs, lbs_weights = self.posedirs, self.lbs_weights
            Vs = template.shape[0]
            dirs2d = dirs_sub.reshape(Vs * 3, -1).T.contiguous()
            tab = dict(j_template=j_template, j_dirs=j_dirs,
                       template=template, dirs2d=dirs2d, pj=None,
                       kept=None, parents=PARENTS)
            if pose_joint_subset is not None and vertex_subset is not None:
                pj = np.asarray(pose_joint_subset, np.int64)
                rows = ((pj - 1)[:, None] * 9 + np.arange(9)).reshape(-1)
                posedirs = posedirs[torch.as_tensor(rows, device=dev)]
                tab["pj"] = torch.as_tensor(pj, device=dev)
            tab["table"] = torch.cat([dirs2d, posedirs], dim=0).contiguous()
            if joint_subset is not None and vertex_subset is not None:
                kept = np.asarray(joint_subset, np.int64)
                kpos = {int(j): i for i, j in enumerate(kept)}
                if not all(PARENTS[int(j)] < 0 or PARENTS[int(j)] in kpos
                           for j in kept):
                    raise ValueError("joint_subset must be ancestor-closed")
                tab["parents"] = tuple(
                    -1 if PARENTS[int(j)] < 0 else kpos[PARENTS[int(j)]]
                    for j in kept)
                tab["kept"] = torch.as_tensor(kept, device=dev)
                lbs_weights = lbs_weights[:, tab["kept"]]
            tab["lbs_weights"] = lbs_weights.contiguous()
        self._cache[key] = tab
        return tab

    # -- forward -------------------------------------------------------------
    def hand_pose_aa(self, coeffs: torch.Tensor, side: str) -> torch.Tensor:
        """PCA coefficients [..., n_pca] -> axis-angle [..., 45]."""
        comp = (self.hands_components_l if side == "l"
                else self.hands_components_r)
        mean = self.hands_mean_l if side == "l" else self.hands_mean_r
        aa = coeffs @ comp
        if not self.flat_hand_mean:
            aa = aa + mean
        return aa

    def forward(self, betas: torch.Tensor, global_orient: torch.Tensor,
                body_pose: Optional[torch.Tensor] = None,
                body_pose_matrot: Optional[torch.Tensor] = None,
                global_orient_matrot: Optional[torch.Tensor] = None,
                transl: Optional[torch.Tensor] = None,
                left_hand_pose: Optional[torch.Tensor] = None,
                right_hand_pose: Optional[torch.Tensor] = None,
                jaw_pose: Optional[torch.Tensor] = None,
                leye_pose: Optional[torch.Tensor] = None,
                reye_pose: Optional[torch.Tensor] = None,
                expression: Optional[torch.Tensor] = None,
                vertex_subset=None, joint_subset=None,
                pose_joint_subset=None,
                **unused_kwargs) -> Dict[str, torch.Tensor]:
        """Batched SMPL-X forward, same contract as the reference's
        ``SmplxModel.__call__``: vertices [B,V,3] (V = len(vertex_subset)
        if given), joints [B,55,3] — NaN at joints outside joint_subset
        when pruned — full_pose [B,55,3] and v_shaped."""
        B = betas.shape[0]
        dev, dtype = self.v_template.device, self.v_template.dtype
        zeros3 = torch.zeros(B, 3, dtype=dtype, device=dev)
        jaw_pose = zeros3 if jaw_pose is None else jaw_pose
        leye_pose = zeros3 if leye_pose is None else leye_pose
        reye_pose = zeros3 if reye_pose is None else reye_pose
        if expression is None:
            expression = torch.zeros(B, self.num_expr, dtype=dtype,
                                     device=dev)
        if left_hand_pose is None:
            left_hand_pose = torch.zeros(B, self.num_pca, dtype=dtype,
                                         device=dev)
        if right_hand_pose is None:
            right_hand_pose = torch.zeros(B, self.num_pca, dtype=dtype,
                                          device=dev)
        lhand_aa = self.hand_pose_aa(left_hand_pose, "l")
        rhand_aa = self.hand_pose_aa(right_hand_pose, "r")
        if body_pose_matrot is None:
            body_aa = body_pose.reshape(B, NUM_BODY_JOINTS, 3)
        else:
            body_aa = torch.zeros(B, NUM_BODY_JOINTS, 3, dtype=dtype,
                                  device=dev)
        full_pose = torch.cat([
            global_orient.reshape(B, 1, 3), body_aa,
            jaw_pose.reshape(B, 1, 3), leye_pose.reshape(B, 1, 3),
            reye_pose.reshape(B, 1, 3), lhand_aa.reshape(B, 15, 3),
            rhand_aa.reshape(B, 15, 3)], dim=1)

        tab = self._tables(vertex_subset, joint_subset, pose_joint_subset)
        # 1-2. shape blendshapes; rest joints from the composed
        # regressor table (never materializes the full shaped mesh)
        shape_feat = torch.cat([betas, expression], dim=-1)
        j_rest = tab["j_template"] + (shape_feat @ tab["j_dirs"]).reshape(
            B, NUM_JOINTS, 3)
        template = tab["template"]
        v_shaped = template + (shape_feat @ tab["dirs2d"]).reshape(
            B, -1, 3)

        # 3. per-joint rotation matrices (aa joints converted in one
        # batched chain, given matrices spliced in) + pose blendshapes
        if body_pose_matrot is None and global_orient_matrot is None:
            rot_mats = aa_to_matrot(full_pose)
        else:
            aa_parts = []
            if global_orient_matrot is None:
                aa_parts.append(full_pose[:, :1])
            if body_pose_matrot is None:
                aa_parts.append(full_pose[:, 1:1 + NUM_BODY_JOINTS])
            aa_parts.append(full_pose[:, 1 + NUM_BODY_JOINTS:])
            conv = aa_to_matrot(torch.cat(aa_parts, dim=1))
            i = 0
            if global_orient_matrot is None:
                head, i = conv[:, :1], 1
            else:
                head = global_orient_matrot.reshape(B, 1, 3, 3)
            if body_pose_matrot is None:
                body_m = conv[:, i:i + NUM_BODY_JOINTS]
                i += NUM_BODY_JOINTS
            else:
                body_m = body_pose_matrot
            rot_mats = torch.cat([head, body_m, conv[:, i:]], dim=1)
        eye = torch.eye(3, dtype=dtype, device=dev)
        if tab["pj"] is not None:
            pose_feat = (rot_mats[:, tab["pj"]] - eye).reshape(B, -1)
        else:
            pose_feat = (rot_mats[:, 1:] - eye).reshape(B, -1)
        # one merged matmul applies shape AND pose blendshapes
        feat = torch.cat([shape_feat, pose_feat], dim=-1)
        v_posed = template + (feat @ tab["table"]).reshape(B, -1, 3)

        # 4. forward kinematics (pruned to the ancestor-closed support)
        if tab["kept"] is not None:
            kept = tab["kept"]
            joints_k, rel_k = batch_rigid_transform(
                rot_mats[:, kept], j_rest[:, kept], tab["parents"])
            joints_world = torch.full((B, NUM_JOINTS, 3), float("nan"),
                                      dtype=dtype, device=dev
                                      ).index_copy(1, kept, joints_k)
            A = rel_k[..., :3, :].reshape(B, len(kept), 12)
        else:
            joints_world, rel_transforms = batch_rigid_transform(
                rot_mats, j_rest, PARENTS)
            A = rel_transforms[..., :3, :].reshape(B, NUM_JOINTS, 12)

        # 5. linear blend skinning (3x4 blended affine per vertex)
        Tm = torch.matmul(tab["lbs_weights"], A).reshape(B, -1, 3, 4)
        v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])],
                           dim=-1)
        verts = torch.einsum("bvpq,bvq->bvp", Tm, v_homo)
        if transl is not None:
            verts = verts + transl[:, None, :]
            joints_world = joints_world + transl[:, None, :]
        return {"vertices": verts, "joints": joints_world,
                "full_pose": full_pose, "v_shaped": v_shaped}


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: Tuple[int, ...]):
    """Forward kinematics: rot_mats [B,J,3,3], rest joints [B,J,3] ->
    posed joints [B,J,3] and skinning-relative transforms [B,J,4,4],
    through ``fk.rigid_transform_prod`` (looked up at each call, so a
    test or a measurement can swap the hand-written adjoint in)."""
    return fk.rigid_transform_prod(rot_mats, joints, tuple(parents))


# ---------------------------------------------------------------------------
# Loading / construction
# ---------------------------------------------------------------------------

def load_npz(path: str, num_betas: int = 10, num_expr: int = 10,
             num_pca: int = 12, device="cpu") -> SmplxModel:
    """Load an official SMPL-X .npz artifact (e.g. SMPLX_NEUTRAL.npz)."""
    data = np.load(path, allow_pickle=True)
    shapedirs_all = np.asarray(data["shapedirs"], dtype=np.float32)
    shapedirs = shapedirs_all[..., :num_betas]
    if shapedirs_all.shape[-1] > 300:       # shape | expression split
        exprdirs = shapedirs_all[..., 300:300 + num_expr]
    else:
        exprdirs = np.zeros(shapedirs.shape[:2] + (num_expr,), np.float32)
    posedirs = np.asarray(data["posedirs"], dtype=np.float32)
    V = posedirs.shape[0]
    posedirs = posedirs.reshape(V * 3, -1).T        # [(J-1)*9, V*3]
    lmk_f = (np.asarray(data["lmk_faces_idx"], np.int32)
             if "lmk_faces_idx" in data else None)
    lmk_b = (np.asarray(data["lmk_bary_coords"], np.float32)
             if "lmk_bary_coords" in data else None)
    return SmplxModel(
        v_template=data["v_template"], shapedirs=shapedirs,
        exprdirs=exprdirs, posedirs=posedirs,
        j_regressor=data["J_regressor"], lbs_weights=data["weights"],
        hands_components_l=data["hands_componentsl"][:num_pca],
        hands_components_r=data["hands_componentsr"][:num_pca],
        hands_mean_l=data["hands_meanl"], hands_mean_r=data["hands_meanr"],
        faces=data["f"], lmk_faces_idx=lmk_f, lmk_bary_coords=lmk_b,
        device=device)


# Approximate rest-pose joint locations (meters, y-up) of the synthetic
# stand-in model: body joints only; face/hand joints get small offsets.
_REST_BODY = np.array([
    [0.00, 0.00, 0.00],    # pelvis
    [0.09, -0.07, 0.00],   # left_hip
    [-0.09, -0.07, 0.00],  # right_hip
    [0.00, 0.12, 0.00],    # spine1
    [0.10, -0.48, 0.00],   # left_knee
    [-0.10, -0.48, 0.00],  # right_knee
    [0.00, 0.25, 0.00],    # spine2
    [0.10, -0.88, -0.02],  # left_ankle
    [-0.10, -0.88, -0.02], # right_ankle
    [0.00, 0.32, 0.00],    # spine3
    [0.11, -0.94, 0.10],   # left_foot
    [-0.11, -0.94, 0.10],  # right_foot
    [0.00, 0.48, 0.00],    # neck
    [0.07, 0.42, 0.00],    # left_collar
    [-0.07, 0.42, 0.00],   # right_collar
    [0.00, 0.58, 0.02],    # head
    [0.17, 0.44, 0.00],    # left_shoulder
    [-0.17, 0.44, 0.00],   # right_shoulder
    [0.43, 0.42, 0.00],    # left_elbow
    [-0.43, 0.42, 0.00],   # right_elbow
    [0.68, 0.42, 0.00],    # left_wrist
    [-0.68, 0.42, 0.00],   # right_wrist
    [0.00, 0.60, 0.06],    # jaw
    [0.03, 0.65, 0.08],    # left_eye
    [-0.03, 0.65, 0.08],   # right_eye
], dtype=np.float32)


def _synthetic_rest_joints() -> np.ndarray:
    """[55,3] plausible rest skeleton."""
    joints = np.zeros((NUM_JOINTS, 3), dtype=np.float32)
    joints[:25] = _REST_BODY
    for side, wrist, sgn in (("l", 20, 1.0), ("r", 21, -1.0)):
        base = 25 if side == "l" else 40
        for f in range(5):                    # index,middle,pinky,ring,thumb
            z = (f - 2) * 0.018
            for k in range(3):
                j = base + f * 3 + k
                joints[j] = joints[wrist] + np.array(
                    [sgn * (0.05 + 0.025 * (k + 1)), -0.01 * f, z],
                    dtype=np.float32)
    return joints


def synthetic_vertex_bones(num_verts: int, seed: int = 0) -> np.ndarray:
    """[V] generating bone of each synthetic vertex — replicates
    synthetic_model's FIRST rng draw exactly (same seed, same call)."""
    rng = np.random.RandomState(seed)
    return rng.randint(1, NUM_JOINTS, size=num_verts)


def _tree_hops(parents: np.ndarray) -> np.ndarray:
    """[J,J] hop distance over the kinematic tree (BFS per node)."""
    J = len(parents)
    adj = [[] for _ in range(J)]
    for j in range(1, J):
        adj[j].append(int(parents[j]))
        adj[int(parents[j])].append(j)
    hops = np.full((J, J), J, np.int32)
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


def synthetic_arrays(num_verts: int = 1024, num_betas: int = 10,
                     num_expr: int = 10, num_pca: int = 12, seed: int = 0,
                     sparse_weights: bool = False,
                     sparse_posedirs: bool = False) -> Dict[str, np.ndarray]:
    """The synthetic SMPL-X stand-in's arrays, in pure numpy — the same
    draws, in the same order, as the reference's ``synthetic_model``,
    so the arrays are bit-identical for the same seed. Keys: LEAVES,
    faces, lmk_faces_idx, lmk_bary_coords."""
    rng = np.random.RandomState(seed)
    rest = _synthetic_rest_joints()
    parents = np.asarray(PARENTS)

    seg_j = rng.randint(1, NUM_JOINTS, size=num_verts)
    t = rng.rand(num_verts, 1).astype(np.float32)
    a = rest[seg_j]
    b = rest[parents[seg_j]]
    verts = a * t + b * (1 - t)
    verts += rng.randn(num_verts, 3).astype(np.float32) * 0.04

    d2 = ((verts[:, None, :] - rest[None, :, :]) ** 2).sum(-1)
    w = np.exp(-d2 / (2 * 0.05 ** 2))
    w /= w.sum(axis=1, keepdims=True) + 1e-12
    if sparse_weights:
        # kinematically local top-4 weights, renormalized
        hops = _tree_hops(parents)
        local = ((hops[seg_j] <= 2) | (hops[parents[seg_j]] <= 2))
        w_m = np.where(local, w, 0.0)
        rows = np.arange(num_verts)[:, None]
        top = np.argsort(w_m, axis=1)[:, -4:]
        w_s = np.zeros_like(w)
        w_s[rows, top] = w_m[rows, top]
        w = w_s / (w_s.sum(axis=1, keepdims=True) + 1e-12)

    jreg = np.zeros((NUM_JOINTS, num_verts), dtype=np.float32)
    near = np.argsort(d2, axis=0)
    k = max(4, num_verts // 256)
    for j in range(NUM_JOINTS):
        jreg[j, near[:k, j]] = 1.0 / k

    shapedirs = rng.randn(num_verts, 3, num_betas).astype(np.float32) * 0.01
    exprdirs = rng.randn(num_verts, 3, num_expr).astype(np.float32) * 0.002
    posedirs = (rng.randn((NUM_JOINTS - 1) * 9, num_verts * 3)
                .astype(np.float32) * 0.001)
    if sparse_posedirs:
        allow = ((w[:, 1:] > 0) | (w[:, parents[1:]] > 0))
        mask = np.repeat(np.repeat(allow.T, 9, axis=0), 3, axis=1)
        posedirs *= mask.astype(np.float32)
    hands_comp_l = rng.randn(num_pca, 45).astype(np.float32) * 0.1
    hands_comp_r = rng.randn(num_pca, 45).astype(np.float32) * 0.1
    hands_mean = rng.randn(2, 45).astype(np.float32) * 0.05

    num_faces = max(1, num_verts * 2 - 4)
    faces = rng.randint(0, num_verts, size=(num_faces, 3)).astype(np.int32)

    head_d2 = ((verts - rest[15]) ** 2).sum(-1)
    face_centroid_d2 = head_d2[faces].mean(axis=1)
    lmk_faces_idx = np.argsort(face_centroid_d2)[:51].astype(np.int32)
    bary = rng.rand(51, 3).astype(np.float32) + 0.1
    lmk_bary_coords = bary / bary.sum(axis=1, keepdims=True)
    lmk_vids = np.unique(faces[lmk_faces_idx].ravel())
    exprdirs[lmk_vids] = (rng.randn(len(lmk_vids), 3, num_expr)
                          .astype(np.float32) * 0.02)

    f32 = lambda x: np.asarray(x, np.float32)
    return dict(v_template=f32(verts), shapedirs=f32(shapedirs),
                exprdirs=f32(exprdirs), posedirs=f32(posedirs),
                j_regressor=f32(jreg), lbs_weights=f32(w),
                hands_components_l=f32(hands_comp_l),
                hands_components_r=f32(hands_comp_r),
                hands_mean_l=f32(hands_mean[0]),
                hands_mean_r=f32(hands_mean[1]),
                faces=faces, lmk_faces_idx=lmk_faces_idx,
                lmk_bary_coords=lmk_bary_coords)


def synthetic_model(num_verts: int = 1024, num_betas: int = 10,
                    num_expr: int = 10, num_pca: int = 12, seed: int = 0,
                    sparse_weights: bool = False,
                    sparse_posedirs: bool = False,
                    device="cpu") -> SmplxModel:
    """Deterministic synthetic SMPL-X-shaped model (see synthetic_arrays;
    the licensed artifact is not redistributable)."""
    arrays = synthetic_arrays(num_verts, num_betas, num_expr, num_pca,
                              seed, sparse_weights, sparse_posedirs)
    return SmplxModel(**arrays, device=device)
