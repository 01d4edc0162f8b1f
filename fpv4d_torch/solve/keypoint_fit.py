"""SMPLify-X-style fitting from 2D keypoints (port of
fpv4d/solve/keypoint_fit.py).

A staged perspective-reprojection fit of SMPL-X parameters to OpenPose
BODY_25 keypoints, over every frame of a clip at once. Stages (the
SMPLify-X schedule):
  1. camera: depth init from torso size, then global_orient +
     camera_translation on torso joints only;
  2. body: + VPoser latent and betas, full-body robust reprojection;
  3. all: + hand PCA coefficients (and, with face keypoints, jaw pose
     and expression), all priors.

Losses: Geman-McClure robust reprojection (confidence-weighted),
VPoser latent L2, betas L2, hand-PCA L2, expression and jaw L2.

Output: [T, 75] canonical parameter vectors (models/params.py layout)
with transl = 0 and the camera offset in camera_translation, the
convention of the reference's body_gen pkls.

Three optimizers, as in the reference:
  * 'adam': ONE Adam state (solve/adam.py, optax's arithmetic) over all
    eight variables, threaded through the three stages as the
    reference's one ``opt_state``. Every variable takes an Adam step
    every step: a stage's masked variables enter the loss detached, get
    a zero gradient and keep moving on the moments they gathered
    earlier, as optax's masked updates make them. Each stage's step
    runs through a phase program (solve/step_graph.py), the counterpart
    of the reference's jitted ``run_stage`` scan: on the card it is
    captured once per stage as a CUDA graph and replayed
    (``step_graphs``), and everything it reads (keypoints, face
    keypoints, each stage's joint weights, the model's tables) sits at
    one address for the whole fit. The reference shares one program
    between the stages through a traced mask; here each stage's mask is
    the detach form, so each stage is a capture of its own (3 in all);
  * 'lbfgs': optax's L-BFGS with the zoom line search over the clip's
    whole objective (solve/lbfgs.py), a fresh state per stage;
  * 'lbfgs_perframe': the same direction with a bounded backtracking
    line search and one memory and step size per frame, the frames
    batched as lanes.
The L-BFGS stages freeze masked variables inside the objective,
``x*m + x.detach()*(1-m)``, as the reference's stop_gradient splice.
Their iterations run through the same phase program, the counterpart of
the reference's jitted ``run_stage_lbfgs_joint`` and
``run_stage_lbfgs_perframe`` scans: each of an iteration's five pieces
is captured once per stage on the card, and the line search's rounds
replay one piece until a device flag says every lane has ended.

Keypoints may carry a leading clips axis [C, T, 25, 3] (hands and face
likewise): loss normalization and optimizer state stay per clip (the
clips' losses are summed, so each clip's gradient is its own), and the
histories are [C, iters]. ``mesh=`` spreads the clips axis over
torch.distributed ranks (parallel/sharding.py): each rank fits its
contiguous share of the clips and every rank returns all of them (a
frames axis of the mesh splits nothing here).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fpv4d_torch.config import KeypointFitConfig
from fpv4d_torch.models import vposer as VP
from fpv4d_torch.models.smplx import SmplxModel
from fpv4d_torch.solve import lbfgs, step_graph
from fpv4d_torch.solve.adam import Adam

# BODY_25 slot <- SMPL-X skeleton joint (-1 = no correspondence; ears,
# heels and small toes have no skeleton joint and get weight 0).
BODY25_FROM_SMPLX = np.array([
    22,   # 0  nose        <- jaw (closest skeleton joint)
    12,   # 1  neck
    17,   # 2  RShoulder
    19,   # 3  RElbow
    21,   # 4  RWrist
    16,   # 5  LShoulder
    18,   # 6  LElbow
    20,   # 7  LWrist
    0,    # 8  MidHip      <- pelvis
    2,    # 9  RHip
    5,    # 10 RKnee
    8,    # 11 RAnkle
    1,    # 12 LHip
    4,    # 13 LKnee
    7,    # 14 LAnkle
    24,   # 15 REye
    23,   # 16 LEye
    -1,   # 17 REar
    -1,   # 18 LEar
    10,   # 19 LBigToe     <- left_foot
    -1,   # 20 LSmallToe
    -1,   # 21 LHeel
    11,   # 22 RBigToe     <- right_foot
    -1,   # 23 RSmallToe
    -1,   # 24 RHeel
], dtype=np.int32)

TORSO_BODY25 = np.array([1, 2, 5, 8, 9, 12], dtype=np.int32)

# OpenPose hand-21 slot <- SMPL-X hand joint, per side. OpenPose hand
# layout: 0 wrist, then 4 per finger (thumb 1-4, index 5-8, middle
# 9-12, ring 13-16, pinky 17-20; the 4th of each is the fingertip,
# which has no SMPL-X joint). SMPL-X hand joints (15/side) are ordered
# index1-3, middle1-3, pinky1-3, ring1-3, thumb1-3 (left: 25-39,
# right: 40-54).
_HAND21_SLOTS = np.array([5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15,
                          1, 2, 3], dtype=np.int32)
LHAND_SMPLX = np.arange(25, 40, dtype=np.int32)
RHAND_SMPLX = np.arange(40, 55, dtype=np.int32)

# the decision variables, in the reference's FitVars order
LEAVES = ("global_orient", "camera_translation", "betas", "latent",
          "left_hand", "right_hand", "jaw", "expression")
Vars = Dict[str, torch.Tensor]

# host seconds of each stage's graph captures in the last fit of this
# process, by stage (empty on the eager route)
capture_seconds: Dict[str, float] = {}
# the line-search rounds of each L-BFGS iteration in the last fit of
# this process, by stage (empty for Adam)
lbfgs_rounds: Dict[str, list] = {}


def gmof(x: torch.Tensor, rho: float) -> torch.Tensor:
    """Geman-McClure robustifier rho^2 * d/(d + rho^2), d = x^2."""
    d = x ** 2
    return rho ** 2 * d / (d + rho ** 2)


def gmof_sq(d: torch.Tensor, rho: float) -> torch.Tensor:
    """gmof on an already-squared residual (no sqrt, so no singular
    gradient at 0)."""
    return rho ** 2 * d / (d + rho ** 2)


def project(points_cam: torch.Tensor, focal: float,
            center: torch.Tensor) -> torch.Tensor:
    """Perspective projection [..., 3] -> [..., 2] pixels, depth clamped
    at 1e-4 (a bound made on the device: a captured step uploads
    nothing). torch.maximum splits the gradient evenly at an exact tie,
    as JAX's maximum does."""
    z = points_cam[..., 2:3]
    z = torch.maximum(z, torch.full_like(z, 1e-4))
    return focal * points_cam[..., :2] / z + center


def _merge2(x: torch.Tensor) -> torch.Tensor:
    """[P, F, ...] -> [P*F, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _per_frame(x: torch.Tensor) -> torch.Tensor:
    """[C, T, ...] -> [C*T, 1, ...]: every frame a problem of its own."""
    return x.reshape((-1, 1) + tuple(x.shape[2:]))


def _mean_sq(x: torch.Tensor) -> torch.Tensor:
    """mean(x^2) per problem: [P, F, k] -> [P]."""
    return torch.mean(x ** 2, dim=(1, 2))


def _stage_mask(camera=False, body=False, hands=False,
                face=False) -> Dict[str, float]:
    return dict(global_orient=float(camera), camera_translation=float(camera),
                betas=float(body), latent=float(body),
                left_hand=float(hands), right_hand=float(hands),
                jaw=float(face), expression=float(face))


def init_camera_translation(keypoints: torch.Tensor,
                            rest_joints: torch.Tensor,
                            focal: float) -> torch.Tensor:
    """Depth-from-torso init: z ~= focal * torso_height_3d /
    torso_height_2d (the SMPLify(-X) camera bootstrap). keypoints
    [..., 25+, 3]; rest_joints [55, 3] of the rest body -> [..., 3]."""
    torso3d = rest_joints[torch.as_tensor(
        BODY25_FROM_SMPLX[TORSO_BODY25].astype(np.int64),
        device=rest_joints.device)]
    h3d = torch.linalg.vector_norm(torso3d.amax(0) - torso3d.amin(0))
    torso = torch.as_tensor(TORSO_BODY25.astype(np.int64),
                            device=keypoints.device)
    seen = keypoints[..., torso, 2:3] > 0
    torso2d = keypoints[..., torso, :2] * seen
    span = torso2d.amax(-2) - torso2d.amin(-2)
    h2d = torch.clamp(torch.linalg.vector_norm(span, dim=-1), min=1.0)
    z = focal * h3d / h2d
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z], dim=-1)


class _Objective:
    """total_loss of the reference over problems: variables [P, F, k],
    keypoints [P, F, K, 3] -> one loss per problem [P] (normalized over
    that problem's F frames). The Adam and joint L-BFGS stages take
    P = clips, F = frames; the per-frame L-BFGS P = clips*frames, F = 1."""

    def __init__(self, model: SmplxModel, vposer_params, config, smplx_ids,
                 skin_subset, lmk):
        self.model, self.vp, self.cfg = model, vposer_params, config
        self.ids, self.skin_subset, self.lmk = smplx_ids, skin_subset, lmk
        dev = model.v_template.device
        self.center = torch.tensor([config.image_size[0] / 2.0,
                                    config.image_size[1] / 2.0],
                                   dtype=torch.float32, device=dev)

    def reproj(self, v: Vars, kp, face_kp, joint_w, face_w: float):
        cfg, model = self.cfg, self.model
        P, F = v["betas"].shape[:2]
        pose63 = VP.decode(self.vp, _merge2(v["latent"]))
        out = model(betas=_merge2(v["betas"]),
                    global_orient=_merge2(v["global_orient"]),
                    body_pose=pose63,
                    left_hand_pose=_merge2(v["left_hand"]),
                    right_hand_pose=_merge2(v["right_hand"]),
                    jaw_pose=_merge2(v["jaw"]),
                    expression=_merge2(v["expression"]),
                    vertex_subset=self.skin_subset)
        cam = v["camera_translation"][:, :, None, :]
        j_cam = out["joints"].reshape(P, F, -1, 3) + cam
        j2d = project(j_cam[:, :, self.ids], cfg.focal_length, self.center)
        resid_sq = torch.sum((j2d - kp[..., :2]) ** 2, dim=-1)
        w = kp[..., 2] * joint_w
        num = torch.sum(w * gmof_sq(resid_sq, cfg.gmof_rho), dim=(1, 2))
        den = torch.sum(w, dim=(1, 2))
        if self.lmk is not None:
            # landmarks = bary-weighted corners of the embedded triangles
            _, tri, bary = self.lmk
            verts = out["vertices"].reshape(P, F, -1, 3)
            lmk_cam = torch.einsum("lk,pflkc->pflc", bary,
                                   verts[:, :, tri]) + cam
            l2d = project(lmk_cam, cfg.focal_length, self.center)
            lresid = torch.sum((l2d - face_kp[..., :2]) ** 2, dim=-1)
            wl = face_kp[..., 2] * face_w
            num = num + torch.sum(wl * gmof_sq(lresid, cfg.gmof_rho),
                                  dim=(1, 2))
            den = den + torch.sum(wl, dim=(1, 2))
        return num / (den + 1e-6)

    def __call__(self, v: Vars, kp, face_kp, joint_w, face_w: float):
        cfg = self.cfg
        return (cfg.weight_reproj * self.reproj(v, kp, face_kp, joint_w,
                                                face_w)
                + cfg.weight_vposer * _mean_sq(v["latent"])
                + cfg.weight_shape * _mean_sq(v["betas"])
                + cfg.weight_hand * (_mean_sq(v["left_hand"])
                                     + _mean_sq(v["right_hand"]))
                + cfg.weight_expr * _mean_sq(v["expression"])
                + cfg.weight_jaw * _mean_sq(v["jaw"]))


def _pack(v: Vars) -> torch.Tensor:
    """[P, F, k] variables -> flat [P, F * sum(k)]."""
    x = torch.cat([v[k] for k in LEAVES], dim=-1)
    return x.reshape(x.shape[0], -1)


def _unpack(x: torch.Tensor, sizes: Dict[str, int], F: int) -> Vars:
    parts = torch.split(x.reshape(x.shape[0], F, -1),
                        [sizes[k] for k in LEAVES], dim=-1)
    return dict(zip(LEAVES, parts))


def _run_adam(obj, v: Vars, opt: Adam, kp, face_kp, joint_w, face_w,
              mask, num_iter: int,
              program: Optional[step_graph.PhaseProgram] = None,
              key=("adam",)) -> torch.Tensor:
    """num_iter steps of the shared Adam through `program` (eager
    without one; one capture per `key`); masked variables enter the loss
    detached, so their gradient stays the zero tensor it was reset to.
    Returns the per-clip losses [num_iter, C] on the device."""
    def step():
        opt.zero_grad()
        vm = {k: x if mask[k] else x.detach() for k, x in v.items()}
        loss = obj(vm, kp, face_kp, joint_w, face_w)
        loss.sum().backward()
        opt.step()
        return loss.detach()

    program = program or step_graph.eager(kp.device)
    return program.run(key, step, num_iter)


def _run_lbfgs(obj, v: Vars, kp, face_kp, joint_w, face_w, mask,
               config, per_frame: bool,
               program: Optional[step_graph.PhaseProgram] = None,
               key=("lbfgs",), rounds: Optional[list] = None
               ) -> Tuple[Vars, torch.Tensor]:
    """One L-BFGS stage from a fresh state. Joint: one lane per clip over
    its whole objective (zoom line search). Per frame: one lane per
    frame (backtracking). The iterations' pieces run through `program`
    (eager without one; captured once per `key` + (line search, piece)),
    and `rounds` gets each iteration's line-search rounds. Returns the
    variables and the per-clip history [num_iter, C] (the per-frame
    variant's is the mean over frames)."""
    C, T = v["betas"].shape[:2]
    if per_frame:
        v, kp, face_kp = ({k: _per_frame(x) for k, x in v.items()},
                          _per_frame(kp), _per_frame(face_kp))
    F = v["betas"].shape[1]
    sizes = {k: v[k].shape[-1] for k in LEAVES}
    m = torch.cat([torch.full((sizes[k],), mask[k], dtype=torch.float32,
                              device=kp.device) for k in LEAVES])

    def fn(x: torch.Tensor) -> torch.Tensor:
        xs = x.reshape(x.shape[0], F, -1)
        xs = xs * m + xs.detach() * (1.0 - m)
        return obj(_unpack(xs, sizes, F), kp, face_kp, joint_w, face_w)

    linesearch = "backtracking" if per_frame else "zoom"
    x, hist = lbfgs.minimize(fn, _pack(v), config.num_iter,
                             memory_size=config.lbfgs_memory,
                             linesearch=linesearch, program=program,
                             key=tuple(key) + (linesearch,), rounds=rounds)
    v = _unpack(x, sizes, F)
    if per_frame:
        v = {k: t.reshape(C, T, -1) for k, t in v.items()}
        hist = hist.reshape(config.num_iter, C, T).mean(-1)
    return v, hist


def fit_keypoints(model: SmplxModel, vposer_params: Dict[str, torch.Tensor],
                  keypoints: np.ndarray,
                  config: KeypointFitConfig = KeypointFitConfig(),
                  hand_left: Optional[np.ndarray] = None,
                  hand_right: Optional[np.ndarray] = None,
                  face: Optional[np.ndarray] = None, mesh=None,
                  device="cuda", step_graphs: Optional[bool] = None
                  ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Fit SMPL-X to OpenPose keypoints for a whole clip at once on
    `device` (the card unless the caller asks for the CPU), where the
    model's tables go (in place, as ClipSolver moves them) and the
    VPoser weights are copied.

    keypoints [T, 25, 3] (x, y, confidence) BODY_25 pixels, or
    [C, T, 25, 3] for C clips; hand_left/hand_right optional [*lead, 21,
    3] OpenPose hand keypoints (the 'all' stage adds hand-joint
    reprojection); face optional [*lead, 70, 3] OpenPose face keypoints
    (the 51 internal landmarks, slots 17:68, drive jaw pose and
    expression in the 'all' stage through the model's barycentric
    landmark embedding, which the model must carry).
    Returns ([*lead, 75] canonical params, history dict): per-stage loss
    histories ([iters], or [C, iters]) and the fitted 'jaw' and
    'expression' (the 75-d layout has no face slots).

    mesh: a parallel.sharding.Mesh; with [C, T] keypoints its first axis
    (the clips axis, as the reference splits over mesh.axis_names[0]) of
    R ranks has each rank fit C / R contiguous clips (the clips never
    interact), and the parameters and histories of all C are gathered
    over that axis to every rank; the ranks along its other axes fit the
    same clips whole.

    step_graphs: None captures each Adam stage's step, or each L-BFGS
    stage's iteration pieces (solve/lbfgs.py), as CUDA graphs on a CUDA
    device and runs them eagerly on the CPU; False runs them eagerly on
    either; True on the CPU raises. The capture seconds of each stage
    land in the module's ``capture_seconds``, and each L-BFGS
    iteration's line-search rounds in ``lbfgs_rounds``."""
    if config.optimizer not in ("adam", "lbfgs", "lbfgs_perframe"):
        raise ValueError(f"optimizer={config.optimizer!r}")
    dev = torch.device(device)
    graphs = step_graph.use_graphs(dev, step_graphs)
    model = model.to(dev)
    vposer_params = {k: (v.to(device=dev, dtype=torch.float32)
                         if isinstance(v, torch.Tensor) else torch.tensor(
                             np.asarray(v, np.float32), device=dev))
                     for k, v in vposer_params.items()}
    axis = next(iter(mesh.axes)) if mesh is not None else None
    if np.ndim(keypoints) == 4 and axis and mesh.axes[axis] > 1:
        from fpv4d_torch.parallel import sharding as SH
        lo, hi = SH.clip_range(mesh, len(keypoints), axis)

        def part(a):
            return None if a is None else np.asarray(a)[lo:hi]

        def gather(a):
            return SH.all_gather_axis(torch.as_tensor(a, device=dev), mesh,
                                      axis).cpu().numpy()

        params, hist = fit_keypoints(model, vposer_params, part(keypoints),
                                     config, part(hand_left),
                                     part(hand_right), part(face),
                                     device=dev, step_graphs=graphs)
        return gather(params), {k: gather(v) for k, v in hist.items()}
    kp_np = np.asarray(keypoints, np.float32)
    batched = kp_np.ndim == 4
    lead = tuple(kp_np.shape[:-2])           # (T,) or (C, T)
    C, T = (lead if batched else (1,) + lead)

    # fold hand keypoints into one [*lead, 25+15+15, 3] target array with
    # per-joint smplx ids; missing hands contribute nothing
    hand_targets, hand_ids = [], []
    for kp_h, ids in ((hand_left, LHAND_SMPLX), (hand_right, RHAND_SMPLX)):
        if kp_h is not None:
            hand_targets.append(np.asarray(kp_h, np.float32)
                                [..., _HAND21_SLOTS, :])
            hand_ids.append(ids)
    valid = BODY25_FROM_SMPLX >= 0
    ids_np = np.where(valid, BODY25_FROM_SMPLX, 0)
    w_np = valid.astype(np.float32)
    torso_np = np.zeros(25, np.float32)
    torso_np[TORSO_BODY25] = 1.0
    torso_np *= w_np
    if hand_targets:
        kp_np = np.concatenate([kp_np] + hand_targets, axis=-2)
        ids_np = np.concatenate([ids_np] + hand_ids)
        n_hand = sum(len(i) for i in hand_ids)
        w_np = np.concatenate([w_np, np.ones(n_hand, np.float32)])
        torso_np = np.concatenate([torso_np, np.zeros(n_hand, np.float32)])
    body_np = w_np.copy()
    body_np[25:] = 0.0                 # hands are fitted only in 'all'

    f32 = dict(dtype=torch.float32, device=dev)
    kp = torch.as_tensor(kp_np, **f32).reshape(C, T, -1, 3)
    smplx_ids = torch.as_tensor(ids_np.astype(np.int64), device=dev)
    base_w, body_w, torso_only = (torch.as_tensor(w, **f32)
                                  for w in (w_np, body_np, torso_np))

    # face landmarks: a tiny vertex subset is skinned only when face
    # fitting is active
    lmk = model.landmark_vertex_subset() if face is not None else None
    if lmk is not None:
        vids, tri, bary = lmk
        lmk = (vids, torch.as_tensor(tri.astype(np.int64), device=dev),
               torch.as_tensor(bary, **f32))
        face_kp = torch.as_tensor(np.asarray(face, np.float32)[..., 17:68, :],
                                  **f32).reshape(C, T, 51, 3)
    else:
        face_kp = torch.zeros((C, T, 1, 3), **f32)
    # the reprojection reads only the 55 joints unless face landmarks are
    # fitted (joints regress from the composed regressor tables, not the
    # skinned mesh): skin one dummy vertex then
    skin_subset = lmk[0] if lmk is not None else np.zeros(1, np.int32)
    obj = _Objective(model, vposer_params, config, smplx_ids, skin_subset,
                     lmk)

    with torch.no_grad():
        rest = model(betas=torch.zeros((1, model.num_betas), **f32),
                     global_orient=torch.zeros((1, 3), **f32),
                     body_pose=torch.zeros((1, 63), **f32),
                     vertex_subset=np.zeros(1, np.int32))
        sizes = dict(global_orient=3, betas=model.num_betas, latent=32,
                     left_hand=model.num_pca, right_hand=model.num_pca,
                     jaw=3, expression=model.num_expr)
        v = {k: torch.zeros((C, T, n), **f32) for k, n in sizes.items()}
        v["camera_translation"] = init_camera_translation(
            kp, rest["joints"][0], config.focal_length)

    opt = None
    if config.optimizer == "adam":
        v = {k: x.clone().requires_grad_(True) for k, x in v.items()}
        opt = Adam([v[k] for k in LEAVES], lr=config.lr)

    use_face = lmk is not None
    schedule = [
        ("camera", torso_only, 0.0, _stage_mask(camera=True)),
        ("body", body_w, 0.0, _stage_mask(camera=True, body=True)),
        ("all", base_w, 1.0 if use_face else 0.0,
         _stage_mask(camera=True, body=True, hands=True, face=use_face)),
    ][: config.stages]
    hist = {}
    lbfgs_rounds.clear()
    program = step_graph.PhaseProgram(dev, graphs)
    try:
        for name, joint_w, face_w, mask in schedule:
            if opt is not None:
                h = _run_adam(obj, v, opt, kp, face_kp, joint_w, face_w,
                              mask, config.num_iter, program, (name,))
            else:
                v, h = _run_lbfgs(obj, v, kp, face_kp, joint_w, face_w,
                                  mask, config,
                                  config.optimizer == "lbfgs_perframe",
                                  program, (name,),
                                  lbfgs_rounds.setdefault(name, []))
            h = h.T.cpu().numpy()                          # [C, iters]
            hist[name] = h if batched else h[0]
    finally:
        capture_seconds.clear()
        for k, sec in program.capture_seconds.items():
            capture_seconds[k[0]] = capture_seconds.get(k[0], 0.0) + sec
        program.close()

    with torch.no_grad():
        out = torch.cat([torch.zeros_like(v["global_orient"]),
                         v["global_orient"], v["betas"], v["latent"],
                         v["left_hand"], v["right_hand"],
                         v["camera_translation"]], dim=-1)
    for k in ("jaw", "expression"):
        hist[k] = _to_lead(v[k], lead)
    return _to_lead(out, lead), hist


def _to_lead(x: torch.Tensor, lead) -> np.ndarray:
    """[C, T, k] -> numpy [*lead, k] (lead (T,) or (C, T))."""
    return x.detach().reshape(tuple(lead) + (-1,)).cpu().numpy()
