"""Port parity of the multi-clip fleet: fpv4d_torch's MultiClipSolver
(device="cpu", the kernels' plain versions) against the JAX package's
MultiClipSolver on a one-device mesh (``make_mesh({"clips": 1})``,
frame_axis=None, so it folds clips into frames as the port does), and
against the port's own per-clip ClipSolver.fit.

The scenario is tests/test_torch_clip_solve.py's (sparse skinning and
coherent leg segments, so joint-support pruning engages; a small
per-frame beta variation, so the L1 smoothness terms do not follow
rounding noise), two clips: clip 0 exact, clip 1 with 0.01 N(0, 1)
noise, as bench.py builds its fleet. Both packages are handed the same
grid tables: both packages build their batched grids on their native
route, whose tables are identical (tests/test_torch_native.py,
tests/test_torch_nn.py). The reference runs nn_impl="grid" with
cand_impl="xla", or nn_impl="xla" for brute force, passed explicitly.

Tolerances are the single-clip parity tolerances and for the same
reasons (tests/test_torch_clip_solve.py): histories rtol 1e-4 (skate
1e-3, dct_a 1e-5); the final body_6d 99% of entries within 1e-4 and all
within 2 lr; scale 1e-5; camera_ext 1e-6; c_dct 1e-6 (1e-5 in dct
mode). The port's fleet against the port's per-clip solves on the CPU:
the same tolerances (measured: equal to the last bit but for ~1e-7 in
the chunked skate history)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpv4d.config import ClipConfig as JConfig
from fpv4d.io import native as RN
from fpv4d.models import smplx as jsmplx
from fpv4d.models import vposer as jvp
from fpv4d.ops import contact as jcontact
from fpv4d.ops import sdf as JSDF
from fpv4d.parallel import multi_clip as JMC
from fpv4d.parallel import sharding as JSH
from fpv4d.solve.clip_solve import ClipSolver as JSolver
from fpv4d_torch import convert
from fpv4d_torch.config import ClipConfig as TConfig
from fpv4d_torch.ops import nn as TNN
from fpv4d_torch.ops import sdf as TSDF
from fpv4d_torch.parallel import multi_clip as TMC
from fpv4d_torch.parallel import sharding as TSH
from fpv4d_torch.solve.clip_solve import ClipSolver as TSolver

from helpers import smooth_noise

T, V, C, LR = 12, 512, 2, 0.005


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.RandomState(0)
    model = jsmplx.synthetic_model(num_verts=V, seed=0, sparse_weights=True)
    vp = jvp.random_params(0)
    segs = jcontact.synthetic_segments(V, seed=0, coherent=True)
    body = np.zeros((T, 75), np.float32)
    body[:, 0:3] = smooth_noise(T, 3, rng, 0.3)
    body[:, 3:6] = smooth_noise(T, 3, rng, 0.2)
    body[:, 6:16] = rng.randn(10) * 0.3 + smooth_noise(T, 10, rng, 0.05)
    body[:, 16:48] = smooth_noise(T, 32, rng, 0.5)
    body[:, 48:75] = smooth_noise(T, 27, rng, 0.2)
    body[5, 16:48] = 4.0                      # an outlier frame
    g = 20
    xs, zs = np.meshgrid(np.linspace(-3, 3, g), np.linspace(-3, 3, g))
    scene = np.stack([xs.ravel(), -1.0 + 0.03 * rng.randn(g * g),
                      zs.ravel()], 1).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    cam[:, :3, 3] = smooth_noise(T, 3, rng, 0.2)
    bodies = np.stack([body, body + np.random.RandomState(1).randn(
        T, 75).astype(np.float32) * np.float32(0.01)])
    arrays = {k: np.asarray(getattr(model, k))
              for k in jsmplx.SmplxModel._LEAVES}
    arrays["faces"] = model.faces
    return dict(model=model, vp=vp, vl=np.asarray(segs["L_Leg"], np.int32),
                vr=np.asarray(segs["R_Leg"], np.int32), scene=scene,
                bodies=bodies, cams=np.stack([cam] * C),
                scenes=TMC.pad_scenes([scene, scene[:300]]),
                tmodel=convert.smplx_from_numpy(arrays),
                tvp=convert.vposer_from_numpy(
                    {k: np.asarray(v) for k, v in vp.items()}))


def _cfg(**cfg):
    base = dict(num_iter=20, num_iter_dct=40, window=T, dct_num=3,
                contact_refresh_steps=4, contact_compact=64)
    base.update(cfg)
    return base


def _port(sc, nn_impl="grid", sdf=False, **cfg):
    return TSolver(model=sc["tmodel"], vposer_params=sc["tvp"],
                   scene_verts=sc["scene"],
                   contact_vids=np.concatenate([sc["vl"], sc["vr"]]),
                   contact_vids_left=sc["vl"], contact_vids_right=sc["vr"],
                   config=TConfig(**_cfg(**cfg)), nn_impl=nn_impl,
                   sdf=TSDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
                   if sdf else None, device="cpu")


def _reference(sc, nn_impl="grid", sdf=False, **cfg):
    return JSolver(model=sc["model"], vposer_params=sc["vp"],
                   scene_verts=sc["scene"],
                   contact_vids=np.concatenate([sc["vl"], sc["vr"]]),
                   contact_vids_left=sc["vl"], contact_vids_right=sc["vr"],
                   config=JConfig(cand_impl="xla", **_cfg(**cfg)),
                   nn_impl="xla" if nn_impl == "brute" else nn_impl,
                   sdf=JSDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
                   if sdf else None)


def _check_state(got, want, dct_atol=1e-6):
    """Batched final states, at the single-clip parity tolerances."""
    err = np.abs(got.body_6d.numpy() - np.asarray(want.body_6d))
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               atol=1e-5)
    np.testing.assert_allclose(got.camera_ext.numpy(),
                               np.asarray(want.camera_ext), atol=1e-6)
    np.testing.assert_allclose(got.c_dct.numpy(), np.asarray(want.c_dct),
                               atol=dct_atol)


def _check_hist(got, want, tol):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol.get(k, 1e-4),
                                   err_msg=k)


# mode, contact source, SDF -> the reference's per-phase tolerance
_CASES = {
    ("local", "grid", False): {"local_skate": 1e-3},
    ("global", "brute", False): {},
    ("dct", "grid", False): {"dct_a": 1e-5},
    ("global", "grid", True): {},
}


@pytest.mark.parametrize("mode,nn_impl,sdf", sorted(_CASES))
def test_fleet_matches_reference_fleet(scenario, mode, nn_impl, sdf):
    """local/grid runs the lazy refresh with compaction, the detection
    and the chunked skate; global/brute K2's plain version over the
    padded scenes; dct/grid the hoisted dct_a; global/grid with a floor
    SDF the collision term."""
    sc = scenario
    assert RN.available()
    jmc = JMC.MultiClipSolver(solver=_reference(sc, nn_impl, sdf),
                              mesh=JSH.make_mesh({"clips": 1}),
                              frame_axis=None)
    jstate, jh = jmc.fit(jnp.asarray(sc["bodies"]), jnp.asarray(sc["cams"]),
                         jnp.asarray(sc["scenes"]), mode=mode)
    tmc = TMC.MultiClipSolver(solver=_port(sc, nn_impl, sdf))
    tstate, th = tmc.fit(sc["bodies"], sc["cams"], sc["scenes"], mode=mode)
    _check_hist(th, {k: np.asarray(v) for k, v in jh.items()},
                _CASES[mode, nn_impl, sdf])
    _check_state(tstate, jstate, 1e-5 if mode == "dct" else 1e-6)
    for (bt, st, ct), (bj, sj, cj) in zip(tmc.result_params(tstate),
                                          jmc.result_params(jstate)):
        assert bt.shape == bj.shape == (T, 75)
        np.testing.assert_allclose(bt, bj, atol=2 * LR)
        np.testing.assert_allclose(st, sj, atol=1e-5)


@pytest.mark.parametrize("mode,nn_impl,refresh", [
    ("local", "grid", 4), ("global", "brute", 4), ("dct", "grid", 4),
    ("local", "grid", 0)])
def test_fleet_matches_per_clip_solves(scenario, mode, nn_impl, refresh):
    """The port's fleet against the port's ClipSolver.fit of each clip
    alone (refresh 0: the folded exact grid query in every contact step
    and in the detection)."""
    sc = scenario
    solver = _port(sc, nn_impl, contact_refresh_steps=refresh)
    state_b, hist = TMC.MultiClipSolver(solver=solver).fit(
        sc["bodies"], sc["cams"], sc["scenes"], mode=mode)
    for c in range(C):
        if nn_impl == "grid":
            solver.grid = TNN.build_voxel_grid(
                sc["scenes"][c][np.abs(sc["scenes"][c]).max(1) < 1e5],
                h=solver.grid_h, slots_per_cell=solver.grid_slots)
        else:
            solver.scene = torch.as_tensor(sc["scenes"][c])
        st, h = solver.fit(sc["bodies"][c], sc["cams"][c], mode=mode)
        assert hist.keys() == h.keys()
        for k in h:
            np.testing.assert_allclose(hist[k][:, c], h[k],
                                       rtol=1e-3 if k == "local_skate"
                                       else 1e-4, err_msg=f"{k} clip {c}")
        err = np.abs(state_b.body_6d[c].numpy() - st.body_6d.numpy())
        assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR
        np.testing.assert_allclose(float(state_b.scale[c]), float(st.scale),
                                   atol=1e-5)


def test_chunked_skate_matches_unchunked(scenario):
    """skate_clip_chunk slices the leaves and the Adam moments per
    sub-batch from the shared step count: exact against the one-shot
    phase (C=4 in chunks of 2 against 0)."""
    sc = scenario
    solver = _port(sc)
    bodies = np.concatenate([sc["bodies"], sc["bodies"][::-1] + 0.005])
    cams = np.concatenate([sc["cams"]] * 2)
    scenes = np.concatenate([sc["scenes"]] * 2)
    runs = {}
    for chunk in (0, 2):
        tm = {}
        runs[chunk] = TMC.MultiClipSolver(
            solver=solver, skate_clip_chunk=chunk).fit(
                bodies, cams, scenes, mode="local", timings=tm)
        assert tm["_fences"]["skate"] == 1
    (s0, h0), (s2, h2) = runs[0], runs[2]
    np.testing.assert_allclose(h2["local_skate"], h0["local_skate"],
                               rtol=1e-6)
    for a, b in zip(s2, s0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_timings_fences_and_grid_cache(scenario):
    """Every stage is fenced and timed, with its fence count: one per
    call for init, grids and detect, one per refresh chunk for the lazy
    phases; the grid cache is keyed by the scenes' content."""
    sc = scenario
    mc = TMC.MultiClipSolver(solver=_port(sc))
    tm = {}
    mc.fit(sc["bodies"], sc["cams"], sc["scenes"], mode="local", timings=tm)
    fences = tm.pop("_fences")
    assert set(tm) == set(fences) == {"init", "grids", "refresh", "local_a",
                                      "local_b", "detect", "skate"}
    assert all(v > 0 for v in tm.values())
    n_a = int(20 * 0.8)
    assert fences == {"init": 1, "grids": 1, "refresh": n_a // 4,
                      "local_a": n_a // 4, "local_b": 1, "detect": 1,
                      "skate": 1}
    assert (mc.grid_cache_hits, mc.grid_cache_misses) == (0, 1)
    g1 = mc._get_grids(sc["scenes"])
    assert mc._get_grids(sc["scenes"].copy()) is g1
    moved = sc["scenes"].copy()
    moved[0, 0] += 0.125
    assert mc._get_grids(moved) is not g1
    assert (mc.grid_cache_hits, mc.grid_cache_misses) == (2, 2)
    # the padding is stripped before building: the grid spans the scene
    assert float(g1.origin.abs().max()) < 10.0
    mb = TMC.MultiClipSolver(solver=_port(sc, "brute"))
    assert mb._get_grids(sc["scenes"]) is None


def test_init_batch_outlier_mean_is_per_clip(scenario):
    """The outlier test compares each frame with its own clip's mean
    latent energy: a clip of large latents does not hide another clip's
    outlier frame."""
    sc = scenario
    mc = TMC.MultiClipSolver(solver=_port(sc))
    bodies = sc["bodies"].copy()
    bodies[1, :, 16:48] *= 3.0
    state_b, target_b, weights_b = mc.init_batch(bodies, sc["cams"])
    assert weights_b.shape == (C, T) and state_b.scale.shape == (C,)
    assert weights_b[0, 5] == 0.0 and weights_b[0].sum() == T - 1
    for c in range(C):
        st, tg, w = mc.solver.init_state(bodies[c], sc["cams"][c])
        assert torch.equal(w, weights_b[c]) and torch.equal(tg, target_b[c])
        assert torch.equal(st.body_6d, state_b.body_6d[c])


def test_pad_scenes_and_mesh_checks(scenario):
    """A frames axis that does not divide the clips' T frames, or leaves
    a rank fewer than 2 of them, raises before any rank solves; so does
    a rank outside the mesh."""
    a = np.zeros((5, 3), np.float32)
    b = np.ones((3, 3), np.float32)
    out = TMC.pad_scenes([a, b])
    assert out.shape == (2, 5, 3) and out.dtype == np.float32
    assert np.all(out[1, 3:] == 1e6) and np.all(out[1, :3] == 1.0)
    np.testing.assert_array_equal(out, JMC.pad_scenes([a, b]))
    sc = scenario
    args = (sc["bodies"], sc["cams"], sc["scenes"])
    for frames, match in ((5, "do not split"), (12, "needs >= 2")):
        mc = TMC.MultiClipSolver(solver=_port(sc), mesh=TSH.Mesh(
            {"clips": 1, "frames": frames}))
        with pytest.raises(ValueError, match=match):
            mc.fit(*args, mode="local")
    with pytest.raises(ValueError, match="outside the mesh"):
        TMC.MultiClipSolver(solver=_port(sc), mesh=TSH.Mesh(
            {"clips": 1}, rank=1)).fit(*args, mode="local")
