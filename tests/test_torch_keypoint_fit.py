"""Port parity of the keypoint fit (fpv4d_torch/solve/keypoint_fit.py,
device="cpu") against the JAX package's fit_keypoints on the same
seeded inputs: a 256-vertex synthetic SMPL-X carried across with
convert.smplx_from_numpy (landmark embedding included), the same
VPoser weights, and BODY_25 / hand / face keypoints projected from a
seeded ground truth with 1 px noise.

Tolerances. The first loss of a fit is taken at the shared initial
state: rtol 1e-6. After it the two packages round differently (XLA's
fused f32 against PyTorch's eager ops; the gradients agree to ~1e-5 of
their largest entry along the reference's own trajectory), and Adam's
per-entry normalization amplifies that in the latent entries whose
gradient is near zero: over 10 steps per stage the histories agree to
rtol 1e-4 (measured 1.9e-6 on the port's optax-order Adam,
solve/adam.py; 1.0e-5 on torch.optim.Adam before it) and the parameters
to atol 2e-3 (0.1 lr; measured 2.6e-4, before 1.1e-3), jaw and
expression to 1e-4 (measured 1.1e-6, before 6.6e-6); over 20 steps per
stage the trajectories have parted (up to 0.11 in a latent entry, ~6
lr; before 0.16), while the histories agree to rtol 1e-2 (measured
2.5e-3, before 3.2e-3) and both fits recover the ground truth equally
well (MPJPE within 1 mm of each other; measured 0.08 mm). The L-BFGS
trajectories branch on f32 line-search tests (the algorithm itself is
held to optax in float64 by tests/test_torch_lbfgs.py), so they are
held to what the reference's own tests require on its own fixture,
MPJPE under 10 mm, and to a final loss no worse than 1.25 times the
reference's."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpv4d.config import KeypointFitConfig as JConfig
from fpv4d.models import params as JP
from fpv4d.models import smplx as jsmplx
from fpv4d.models import vposer as JVP
from fpv4d.solve import keypoint_fit as JKF
from fpv4d.utils import bench_problem as JBP
from fpv4d_torch import convert
from fpv4d_torch.config import KeypointFitConfig as TConfig
from fpv4d_torch.models import vposer as TVP
from fpv4d_torch.solve import keypoint_fit as TKF
from fpv4d_torch.solve.adam import Adam
from fpv4d_torch.utils import bench_problem as TBP

T, LR = 6, 0.02
CFG = dict(num_iter=10, lr=LR, weight_hand=0.001, weight_expr=1e-4,
           weight_jaw=1e-3)


def _port_model(model):
    arrays = {k: np.asarray(getattr(model, k))
              for k in jsmplx.SmplxModel._LEAVES}
    arrays.update(faces=model.faces, lmk_faces_idx=model.lmk_faces_idx,
                  lmk_bary_coords=model.lmk_bary_coords)
    return convert.smplx_from_numpy(arrays)


@pytest.fixture(scope="module")
def sc():
    """Ground truth with hands, jaw and expression, and its body, hand
    and face keypoints (1 px noise)."""
    model = jsmplx.synthetic_model(num_verts=256, seed=3)
    vp = JVP.random_params(seed=3)
    rng = np.random.RandomState(4)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    gt = dict(global_orient=f32(rng.randn(T, 3) * 0.1),
              latent=f32(rng.randn(T, 32) * 0.3),
              betas=f32(np.tile(rng.randn(1, 10) * 0.2, (T, 1))),
              cam_t=f32(np.stack([rng.randn(T) * 0.1, rng.randn(T) * 0.1,
                                  3.0 + rng.rand(T)], axis=1)),
              lh=f32(rng.randn(T, 12) * 0.5), rh=f32(rng.randn(T, 12) * 0.5),
              jaw=f32(rng.randn(T, 3) * 0.2), expr=f32(rng.randn(T, 10)))
    out = model(betas=gt["betas"], global_orient=gt["global_orient"],
                body_pose=JVP.decode(vp, gt["latent"]),
                left_hand_pose=gt["lh"], right_hand_pose=gt["rh"],
                jaw_pose=gt["jaw"], expression=gt["expr"])
    cfg = JConfig()
    center = jnp.asarray([cfg.image_size[0] / 2, cfg.image_size[1] / 2])
    cam = np.asarray(gt["cam_t"])[:, None]
    j_cam = np.asarray(out["joints"]) + cam

    def proj(pts):
        p = np.asarray(JKF.project(jnp.asarray(pts), cfg.focal_length,
                                   center))
        return p + rng.randn(*p.shape).astype(np.float32)

    valid = JKF.BODY25_FROM_SMPLX >= 0
    ids = np.where(valid, JKF.BODY25_FROM_SMPLX, 0)
    kp = np.concatenate([proj(j_cam[:, ids]), np.tile(
        valid.astype(np.float32)[None, :, None], (T, 1, 1))], -1)

    def hand_kp(hids):
        h = np.zeros((T, 21, 3), np.float32)
        h[:, JKF._HAND21_SLOTS, :2] = proj(j_cam[:, hids])
        h[:, JKF._HAND21_SLOTS, 2] = 1.0
        return h

    vids, tri, bary = model.landmark_vertex_subset()
    tri_pts = np.asarray(out["vertices"])[:, vids][:, tri]
    face = np.zeros((T, 70, 3), np.float32)
    face[:, 17:68, :2] = proj(np.einsum("lk,tlkc->tlc", bary, tri_pts)
                              + cam)
    face[:, 17:68, 2] = 1.0
    return dict(model=model, vp=vp, gt=gt, kp=kp.astype(np.float32),
                hl=hand_kp(JKF.LHAND_SMPLX), hr=hand_kp(JKF.RHAND_SMPLX),
                face=face, tmodel=_port_model(model),
                tvp=convert.vposer_from_numpy(
                    {k: np.asarray(v) for k, v in vp.items()}))


@pytest.fixture(scope="module")
def noiseless():
    """The reference's own L-BFGS fixture (tests/test_keypoint_fit.py):
    T=4, noiseless body keypoints, seeds 3 and 4."""
    model = jsmplx.synthetic_model(num_verts=256, seed=3)
    vp = JVP.random_params(seed=3)
    rng = np.random.RandomState(4)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    n = 4
    gt = dict(global_orient=f32(rng.randn(n, 3) * 0.1),
              latent=f32(rng.randn(n, 32) * 0.3),
              betas=f32(np.tile(rng.randn(1, 10) * 0.2, (n, 1))),
              cam_t=f32(np.stack([rng.randn(n) * 0.1, rng.randn(n) * 0.1,
                                  3.0 + rng.rand(n)], axis=1)))
    out = model(betas=gt["betas"], global_orient=gt["global_orient"],
                body_pose=JVP.decode(vp, gt["latent"]))
    j_cam = out["joints"] + gt["cam_t"][:, None, :]
    valid = JKF.BODY25_FROM_SMPLX >= 0
    ids = np.where(valid, JKF.BODY25_FROM_SMPLX, 0)
    j2d = JKF.project(jnp.take(j_cam, jnp.asarray(ids), axis=1), 694.0,
                      jnp.asarray([640.0, 360.0]))
    kp = np.concatenate([np.asarray(j2d), np.tile(
        valid.astype(np.float32)[None, :, None], (n, 1, 1))], axis=-1)
    return dict(model=model, vp=vp, gt=gt, kp=kp.astype(np.float32),
                tmodel=_port_model(model),
                tvp=convert.vposer_from_numpy(
                    {k: np.asarray(v) for k, v in vp.items()}))


INPUTS = {"body": (), "hands": ("hl", "hr"), "face_hands": ("hl", "hr",
                                                             "face")}


def _kwargs(sc, which):
    names = dict(hl="hand_left", hr="hand_right", face="face")
    return {names[k]: sc[k] for k in INPUTS[which]}


def _mpjpe(sc, params):
    """Mean 3D error (m) of the fitted BODY_25-mapped joints in camera
    space against the ground truth, through the reference model."""
    d = JP.split(jnp.asarray(params))
    model, vp, gt = sc["model"], sc["vp"], sc["gt"]
    o = model(betas=d["betas"], global_orient=d["global_orient"],
              body_pose=JVP.decode(vp, d["body_pose"]))
    o_gt = model(betas=gt["betas"], global_orient=gt["global_orient"],
                 body_pose=JVP.decode(vp, gt["latent"]))
    valid = JKF.BODY25_FROM_SMPLX >= 0
    sel = np.unique(JKF.BODY25_FROM_SMPLX[valid])
    j_f = (np.asarray(o["joints"])
           + np.asarray(d["camera_translation"])[:, None])
    j_gt = np.asarray(o_gt["joints"]) + np.asarray(gt["cam_t"])[:, None]
    return float(np.linalg.norm(j_f[:, sel] - j_gt[:, sel], axis=-1).mean())


# -- small functions ------------------------------------------------------------

def test_tables_are_the_reference_tables():
    for name in ("BODY25_FROM_SMPLX", "TORSO_BODY25", "_HAND21_SLOTS",
                 "LHAND_SMPLX", "RHAND_SMPLX"):
        np.testing.assert_array_equal(getattr(TKF, name),
                                      getattr(JKF, name), err_msg=name)


def test_gmof_matches_reference():
    x = np.array([0.0, 1.0, -3.5, 250.0, 1e6], np.float32)
    for rho in (1.0, 100.0):
        np.testing.assert_allclose(
            TKF.gmof(torch.tensor(x), rho).numpy(),
            np.asarray(JKF.gmof(jnp.asarray(x), rho)), rtol=1e-6)
        np.testing.assert_allclose(
            TKF.gmof_sq(torch.tensor(x ** 2), rho).numpy(),
            np.asarray(JKF.gmof_sq(jnp.asarray(x ** 2), rho)), rtol=1e-6)


def test_project_matches_reference_values_and_tie_gradient():
    """Values and gradients, including a point exactly at the 1e-4 depth
    clamp, where JAX's maximum splits the gradient evenly (so does
    torch.maximum)."""
    import jax
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 7, 3).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 0.5
    pts[0, 0, 2] = 1e-4                       # an exact tie at the clamp
    pts[0, 1, 2] = -2.0                       # behind the camera
    center = np.array([640.0, 360.0], np.float32)
    ref = np.asarray(JKF.project(jnp.asarray(pts), 694.0,
                                 jnp.asarray(center)))
    p = torch.tensor(pts, requires_grad=True)
    out = TKF.project(p, 694.0, torch.tensor(center))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6)
    g = rng.randn(*ref.shape).astype(np.float32)
    jg = jax.grad(lambda q: jnp.sum(JKF.project(q, 694.0, jnp.asarray(
        center)) * g))(jnp.asarray(pts))
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-3)
    assert p.grad[0, 1, 2] == 0.0 and p.grad[0, 0, 2] != 0.0


def test_camera_init_matches_reference(sc):
    rest = sc["model"](betas=jnp.zeros((1, 10)),
                       global_orient=jnp.zeros((1, 3)),
                       body_pose=jnp.zeros((1, 63)))
    kp_b = np.stack([sc["kp"], sc["kp"] * 0.5])
    kp_b[1, 2, TKF.TORSO_BODY25[0], 2] = 0.0  # an unseen torso joint
    for kp in (sc["kp"], kp_b):
        ref = np.asarray(JKF.init_camera_translation(
            jnp.asarray(kp), rest["joints"][0], 694.0))
        got = TKF.init_camera_translation(
            torch.tensor(kp), torch.tensor(np.asarray(rest["joints"][0])),
            694.0)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def test_landmark_subset_and_dummy_vertex_forward(sc):
    """The landmark embedding matches the reference's; a forward that
    skins one dummy vertex still returns all 55 joints, equal to the
    full forward's."""
    tm = sc["tmodel"]
    for a, b in zip(tm.landmark_vertex_subset(),
                    sc["model"].landmark_vertex_subset()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(1)
    kw = dict(betas=torch.tensor(rng.randn(3, 10), dtype=torch.float32),
              global_orient=torch.tensor(rng.randn(3, 3) * 0.2,
                                         dtype=torch.float32),
              body_pose=torch.tensor(rng.randn(3, 63) * 0.2,
                                     dtype=torch.float32))
    full = tm(**kw)
    one = tm(**kw, vertex_subset=np.zeros(1))
    assert one["vertices"].shape == (3, 1, 3)
    assert one["joints"].shape == (3, 55, 3)
    assert bool(torch.isfinite(one["joints"]).all())
    torch.testing.assert_close(one["joints"], full["joints"], rtol=0,
                               atol=0)


# -- Adam -----------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(INPUTS))
def test_adam_fit_matches_reference(sc, which):
    kw = _kwargs(sc, which)
    for n in (10, 20):
        cfg = dict(CFG, num_iter=n)
        jp, jh = JKF.fit_keypoints(sc["model"], sc["vp"], sc["kp"],
                                   JConfig(**cfg), **kw)
        tp, th = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], sc["kp"],
                                   TConfig(**cfg), **kw, device="cpu")
        assert tp.shape == jp.shape == (T, 75)
        assert th.keys() == jh.keys()
        assert abs(th["camera"][0] - jh["camera"][0]) <= (
            1e-6 * jh["camera"][0])
        for k in ("camera", "body", "all"):
            assert th[k].shape == (n,)
            np.testing.assert_allclose(th[k], jh[k],
                                       rtol=1e-4 if n == 10 else 1e-2,
                                       err_msg=f"{n} {k}")
            assert th[k][-1] < th[k][0]
        for k in ("jaw", "expression"):
            assert th[k].shape == jh[k].shape == (T, 3 if k == "jaw"
                                                  else 10)
        if n == 10:
            np.testing.assert_allclose(tp, jp, atol=2e-3, rtol=0)
            for k in ("jaw", "expression"):
                np.testing.assert_allclose(th[k], jh[k], atol=1e-4, rtol=0)
        else:
            assert abs(_mpjpe(sc, tp) - _mpjpe(sc, jp)) < 1e-3
        if "face" not in INPUTS[which]:
            # no face keypoints: the face variables never move
            assert np.abs(th["jaw"]).max() == 0.0
            assert np.abs(th["expression"]).max() == 0.0


def test_one_adam_count_across_stages(sc):
    """The hands, masked in 'camera' and 'body', take their first step in
    'all' at the shared step count 3 (optax keeps one count for all
    eight variables): |step| = lr (0.1 / (1 - 0.9^3)) / sqrt(0.001 /
    (1 - 0.999^3)) ~ 0.639 lr, where a count of their own would give lr."""
    cfg = dict(CFG, num_iter=1)
    kw = _kwargs(sc, "hands")
    tp, _ = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], sc["kp"],
                              TConfig(**cfg), **kw, device="cpu")
    jp, _ = JKF.fit_keypoints(sc["model"], sc["vp"], sc["kp"],
                              JConfig(**cfg), **kw)
    step = LR * (0.1 / (1 - 0.9 ** 3)) / np.sqrt(0.001 / (1 - 0.999 ** 3))
    np.testing.assert_allclose(np.abs(tp[:, 48:72]), step, rtol=1e-3)
    np.testing.assert_allclose(tp[:, 48:72], jp[:, 48:72], rtol=1e-5)


def test_masked_leaf_keeps_moving_on_its_moments(sc):
    """A variable that gathered Adam moments keeps moving when a later
    stage masks it: its gradient is a zero tensor, never None, and the
    one Adam's count (optax's, shared by all eight) reaches 6."""
    tm = sc["tmodel"]
    ids = np.where(TKF.BODY25_FROM_SMPLX >= 0, TKF.BODY25_FROM_SMPLX, 0)
    obj = TKF._Objective(tm, sc["tvp"], TConfig(), torch.as_tensor(
        ids.astype(np.int64)), np.zeros(1, np.int32), None)
    kp = torch.tensor(sc["kp"])[None]
    face_kp = torch.zeros(1, T, 1, 3)
    w = torch.tensor((TKF.BODY25_FROM_SMPLX >= 0).astype(np.float32))
    v = {k: torch.zeros(1, T, n) for k, n in (
        ("global_orient", 3), ("betas", 10), ("latent", 32),
        ("left_hand", 12), ("right_hand", 12), ("jaw", 3),
        ("expression", 10))}
    v["camera_translation"] = torch.tensor([0.0, 0.0, 3.0]).repeat(1, T, 1)
    v = {k: x.requires_grad_(True) for k, x in v.items()}
    opt = Adam([v[k] for k in TKF.LEAVES], lr=LR)
    all_on = TKF._stage_mask(camera=True, body=True)
    TKF._run_adam(obj, v, opt, kp, face_kp, w, 0.0, all_on, 3)
    before = v["betas"].detach().clone()
    TKF._run_adam(obj, v, opt, kp, face_kp, w, 0.0,
                  TKF._stage_mask(camera=True), 3)
    assert v["betas"].grad is not None
    assert torch.count_nonzero(v["betas"].grad) == 0
    assert (v["betas"].detach() - before).abs().min() > 0
    assert int(opt.count) == 6


def test_batched_clips_equal_the_per_clip_loop(sc):
    """[C, T] keypoints: per-clip normalization, state and histories, so
    the batched fit equals fitting each clip alone (f32 summation order
    of the batched forward aside)."""
    cfg = TConfig(**dict(CFG, num_iter=8))
    kp1 = sc["kp"].copy()
    kp1[..., :2] += np.random.RandomState(9).randn(
        *kp1[..., :2].shape).astype(np.float32) * 3.0
    kp_b = np.stack([sc["kp"], kp1])
    hl_b, hr_b = np.stack([sc["hl"]] * 2), np.stack([sc["hr"]] * 2)
    for opt in ("adam", "lbfgs", "lbfgs_perframe"):
        c = dataclasses.replace(cfg, optimizer=opt)
        p_b, h_b = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], kp_b, c,
                                     hand_left=hl_b, hand_right=hr_b,
                                     device="cpu")
        assert p_b.shape == (2, T, 75)
        assert h_b["all"].shape == (2, 8) and h_b["jaw"].shape == (2, T, 3)
        for i, kp in enumerate((sc["kp"], kp1)):
            p_s, h_s = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], kp, c,
                                         hand_left=sc["hl"],
                                         hand_right=sc["hr"], device="cpu")
            np.testing.assert_allclose(p_b[i], p_s, atol=2e-5, rtol=1e-4,
                                       err_msg=f"{opt} clip {i}")
            for k in ("camera", "body", "all"):
                np.testing.assert_allclose(h_b[k][i], h_s[k], rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"{opt} clip {i} {k}")


# -- L-BFGS ---------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,num_iter", [("lbfgs", 60),
                                                ("lbfgs_perframe", 30)])
def test_lbfgs_fit_matches_reference(noiseless, optimizer, num_iter):
    """The reference's L-BFGS recovery test on its own fixture and
    iteration counts, for both packages."""
    sc = noiseless
    cfg = dict(num_iter=num_iter, lr=LR, optimizer=optimizer)
    jp, jh = JKF.fit_keypoints(sc["model"], sc["vp"], sc["kp"],
                               JConfig(**cfg))
    tp, th = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], sc["kp"],
                               TConfig(**cfg), device="cpu")
    assert abs(th["camera"][0] - jh["camera"][0]) <= 1e-6 * jh["camera"][0]
    assert np.all(np.isfinite(tp)) and th["all"].shape == (num_iter,)
    assert th["all"][-1] < 0.5 * th["camera"][0]
    assert _mpjpe(sc, tp) < 0.010 and _mpjpe(sc, jp) < 0.010
    # near the noiseless optimum the f32 line searches part ways; the
    # port must end no worse than 1.25x the reference's final loss
    # (measured 0.99x joint, 0.58x per frame)
    assert th["all"][-1] <= 1.25 * jh["all"][-1]


def test_perframe_mean_history_rises_in_both_packages():
    """The per-frame L-BFGS's history is the mean over frames; a frame
    whose 16 backtracking trials all fail still takes the last (the
    bounded search), so on keypoint_problem the camera stage's mean
    jumps after its first step in the reference as in the port, and the
    two agree step for step until the searches part."""
    model = jsmplx.synthetic_model(num_verts=512, seed=0,
                                   sparse_weights=True)
    vp = JVP.random_params(0)
    kp, _ = JBP.keypoint_problem(model, vp, 24, num_iter=6)
    cfg = dict(num_iter=6, optimizer="lbfgs_perframe", stages=1)
    _, jh = JKF.fit_keypoints(model, vp, kp, JConfig(**cfg))
    _, th = TKF.fit_keypoints(_port_model(model), TVP.random_params(0),
                              kp, TConfig(**cfg), device="cpu")
    np.testing.assert_allclose(th["camera"], jh["camera"], rtol=1e-4)
    assert jh["camera"][1] > 3 * jh["camera"][0]
    assert th["camera"][1] > 3 * th["camera"][0]


def test_unknown_optimizer_raises(sc):
    with pytest.raises(ValueError, match="optimizer"):
        TKF.fit_keypoints(sc["tmodel"], sc["tvp"], sc["kp"],
                          TConfig(optimizer="sgd"), device="cpu")


def test_allow_slow_perframe_never_raises(sc):
    """The port keeps the flag for the signature; nothing guards
    'lbfgs_perframe'."""
    cfg = TConfig(num_iter=2, optimizer="lbfgs_perframe")
    for allow in (False, True):
        p, _ = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], sc["kp"],
                                 dataclasses.replace(
                                     cfg, allow_slow_perframe=allow),
                                 device="cpu")
        assert np.all(np.isfinite(p))


# -- the bench problem ------------------------------------------------------------

def test_keypoint_problem_matches_reference():
    """Same seed, same draws, 2 px noise: the port's target is the
    reference's."""
    model = jsmplx.synthetic_model(num_verts=512, seed=0,
                                   sparse_weights=True)
    vp = JVP.random_params(0)
    kp_j, cfg_j = JBP.keypoint_problem(model, vp, 12, num_iter=7)
    kp_t, cfg_t = TBP.keypoint_problem(
        _port_model(model), TVP.random_params(0, device="cpu"), 12,
        num_iter=7)
    assert kp_t.shape == kp_j.shape == (12, 25, 3)
    assert kp_t.dtype == np.float32
    np.testing.assert_allclose(kp_t, kp_j, rtol=1e-5, atol=1e-3)
    assert cfg_t.num_iter == cfg_j.num_iter == 7
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)


def test_mesh_places_the_clips_axis(sc):
    """mesh=: a one-rank mesh fits every clip here (the 2-rank split is
    tests/test_torch_sharding.py's gloo run); a clip count the clips
    axis does not divide raises before any rank fits."""
    from fpv4d_torch.parallel import sharding as SH
    cfg = TConfig(**dict(CFG, num_iter=3))
    kp_b = np.stack([sc["kp"], sc["kp"] + np.float32(2.0)])
    p0, h0 = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], kp_b, cfg,
                               device="cpu")
    p1, h1 = TKF.fit_keypoints(sc["tmodel"], sc["tvp"], kp_b, cfg,
                               mesh=SH.make_mesh({"clips": 1}), device="cpu")
    np.testing.assert_array_equal(p1, p0)
    for k in h0:
        np.testing.assert_array_equal(h1[k], h0[k])
    with pytest.raises(ValueError, match="do not split"):
        TKF.fit_keypoints(sc["tmodel"], sc["tvp"], np.stack([sc["kp"]] * 3),
                          cfg, mesh=SH.Mesh({"clips": 2}, rank=0),
                          device="cpu")
