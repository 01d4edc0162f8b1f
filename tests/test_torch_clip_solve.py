"""Port parity of the whole slice: ClipSolver.fit(mode="local") of
fpv4d_torch (device="cpu", K1's plain version) against the JAX
package's ClipSolver on the same scenario, model tables, VPoser weights
and voxel grid (the grid built once by the JAX package and carried
across). The reference runs with nn_impl="grid" and cand_impl="xla"
passed explicitly (off the TPU it would otherwise use brute-force NN).

The scenario is the reference's standard-problem recipe at test size
(sparse skinning weights and coherent leg segments, so joint-support
pruning engages), with a small per-frame variation of the betas: with
exactly constant betas, the first Adam step moves every frame by the
same +-lr and the betas' second differences become pure rounding noise,
whose sign the L1 smoothness term then follows — bit-level differences
between XLA and PyTorch would decide the trajectory.

Tolerances: local_a and local_b histories agree to f32 summation order
(rtol 1e-4; measured ~5e-6). The skate phase's L1 terms meet near-zero
differences, where Adam's per-element normalization turns last-bit
gradient differences into +-lr steps for a few entries: rtol 1e-3 on its
history, and on the final body_6d 99% of entries within 1e-4 and all
within 2*lr."""
import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpv4d.config import ClipConfig as JConfig
from fpv4d.models import smplx as jsmplx
from fpv4d.models import vposer as jvp
from fpv4d.ops import contact as jcontact
from fpv4d.solve.clip_solve import ClipSolver as JSolver
from fpv4d_torch import convert
from fpv4d_torch.config import ClipConfig as TConfig
from fpv4d_torch.solve.clip_solve import ClipSolver as TSolver

from helpers import smooth_noise

T, V = 12, 512


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.RandomState(0)
    model = jsmplx.synthetic_model(num_verts=V, seed=0, sparse_weights=True)
    vp = jvp.random_params(0)
    segs = jcontact.synthetic_segments(V, seed=0, coherent=True)
    vl = np.asarray(segs["L_Leg"], np.int32)
    vr = np.asarray(segs["R_Leg"], np.int32)
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
    return dict(model=model, vp=vp, vl=vl, vr=vr, body=body, scene=scene,
                cam=cam)


def _solvers(sc, **cfg):
    base = dict(num_iter=20, window=T, dct_num=3, contact_refresh_steps=4)
    base.update(cfg)
    vids = np.concatenate([sc["vl"], sc["vr"]])
    js = JSolver(model=sc["model"], vposer_params=sc["vp"],
                 scene_verts=sc["scene"], contact_vids=vids,
                 contact_vids_left=sc["vl"], contact_vids_right=sc["vr"],
                 config=JConfig(cand_impl="xla", **base), nn_impl="grid")
    arrays = {k: np.asarray(getattr(sc["model"], k))
              for k in jsmplx.SmplxModel._LEAVES}
    arrays["faces"] = sc["model"].faces
    g = js._grid
    ts = TSolver(model=convert.smplx_from_numpy(arrays),
                 vposer_params=convert.vposer_from_numpy(
                     {k: np.asarray(v) for k, v in sc["vp"].items()}),
                 scene_verts=sc["scene"], contact_vids=vids,
                 contact_vids_left=sc["vl"], contact_vids_right=sc["vr"],
                 config=TConfig(**base),
                 grid=convert.voxel_grid_from_numpy(
                     np.asarray(g.cand_pts), np.asarray(g.cand_idx),
                     np.asarray(g.origin), g.dims, g.h),
                 device="cpu")
    return js, ts


@pytest.mark.parametrize("compact,skate", [(0, 0), (64, 0), (0, 64),
                                           (64, 64)])
def test_local_fit_matches_reference(scenario, compact, skate):
    sc = scenario
    js, ts = _solvers(sc, contact_compact=compact, skate_subset=skate,
                      skate_body_only=bool(skate))
    assert ts._contact_prune is not None      # pruning engages
    if skate:
        np.testing.assert_array_equal(ts._skate_vids, js._skate_vids)
    jstate, jh = js.fit(jnp.asarray(sc["body"]), jnp.asarray(sc["cam"]),
                        mode="local")
    tstate, th = ts.fit(sc["body"], sc["cam"], mode="local")
    assert jh.keys() == th.keys()
    for k, rtol in (("local_a", 1e-4), ("local_b", 1e-4),
                    ("local_skate", 1e-3)):
        assert th[k].shape == jh[k].shape
        np.testing.assert_allclose(th[k], jh[k], rtol=rtol, err_msg=k)
    b_t, b_j = tstate.body_6d.numpy(), np.asarray(jstate.body_6d)
    err = np.abs(b_t - b_j)
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * 0.005
    np.testing.assert_allclose(float(tstate.scale), float(jstate.scale),
                               atol=1e-5)
    np.testing.assert_allclose(tstate.camera_ext.numpy(),
                               np.asarray(jstate.camera_ext), atol=1e-6)
    np.testing.assert_allclose(tstate.c_dct.numpy(),
                               np.asarray(jstate.c_dct), atol=1e-6)
    body_t, scale_t, cam_t = ts.result_params(tstate)
    body_j, scale_j, cam_j = js.result_params(jstate)
    assert body_t.shape == body_j.shape == (T, 75)
    np.testing.assert_allclose(body_t, body_j, atol=2 * 0.005)


def test_init_and_terms_match_reference(scenario):
    """init_core's outlier handling and every cal_loss term, at the
    initial state and the first refresh's candidate tables."""
    sc = scenario
    js, ts = _solvers(sc, contact_compact=64, dct_closed_form_init=True)
    jstate, jt6, jw = js.init_state(jnp.asarray(sc["body"]),
                                    jnp.asarray(sc["cam"]))
    tstate, tt6, tw = ts.init_state(sc["body"], sc["cam"])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.numpy()[5] == 0.0               # the outlier frame
    np.testing.assert_allclose(tstate.body_6d.numpy(),
                               np.asarray(jstate.body_6d), atol=1e-6)
    np.testing.assert_allclose(tt6.numpy(), np.asarray(jt6), atol=1e-6)
    np.testing.assert_allclose(tstate.c_dct.numpy(),
                               np.asarray(jstate.c_dct), atol=1e-5)
    jc = js._refresh_cands(jstate)
    tc = ts._refresh_cands(tstate)
    jterms = js.terms(jstate, jt6, jw, js.ctx._replace(grid=jc),
                      prune=js._contact_prune)
    tterms = ts.terms(tstate, tt6, tw, tc, prune=ts._contact_prune)
    for name in tterms._fields:
        np.testing.assert_allclose(float(getattr(tterms, name)),
                                   float(getattr(jterms, name)),
                                   rtol=1e-5, err_msg=name)
    # phase recipes read only their terms but give the reference's loss
    lj = js.contact_a_loss(jterms, js.config.local_contact_mult)
    lt = ts.phase_loss("local_a", tstate, tt6, tw, tc)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(
        ts.detect_contact(tstate).numpy(),
        np.asarray(js.detect_contact(jstate)), rtol=1e-5)


def test_unported_modes_raise(scenario):
    js, ts = _solvers(scenario)
    for mode in ("global", "dct"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.fit(scenario["body"], scenario["cam"], mode=mode)
    with pytest.raises(NotImplementedError):
        TSolver(model=ts.model, vposer_params=ts.vposer_params,
                scene_verts=scenario["scene"], contact_vids=ts.contact_vids,
                contact_vids_left=ts.contact_vids_left,
                contact_vids_right=ts.contact_vids_right,
                config=ts.config, nn_impl="xla", device="cpu")
    with pytest.raises(ValueError):
        TConfig(cand_impl="pallas")


def test_standard_problem_matches_reference(tmp_path):
    """The port's standard problem has the reference's arrays and knobs
    at the same (here reduced) sizes; the reference's model cache goes
    to a temporary directory."""
    from fpv4d.utils.bench_problem import standard_problem as jstd
    from fpv4d_torch.utils.bench_problem import standard_problem as tstd
    kw = dict(T=24, num_verts=V, scene_pts=400, num_iter=10,
              skate_subset=64)
    jp = jstd(cache_dir=str(tmp_path), **kw)
    tp = tstd(device="cpu", **kw)
    np.testing.assert_array_equal(tp.body, jp.body)
    np.testing.assert_array_equal(tp.cam, jp.cam)
    np.testing.assert_array_equal(tp.scene, jp.scene)
    np.testing.assert_array_equal(tp.solver.contact_vids,
                                  jp.solver.contact_vids)
    np.testing.assert_array_equal(tp.solver._skate_vids,
                                  jp.solver._skate_vids)
    jc, tc = jp.solver.config, tp.solver.config
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if f.name == "weights":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        if f.name != "cand_impl":
            assert a == b, f.name
    for k in jsmplx.SmplxModel._LEAVES:
        np.testing.assert_array_equal(getattr(tp.model, k).numpy(),
                                      np.asarray(getattr(jp.model, k)))
    _, hist = tp.solver.fit(tp.body, tp.cam)
    for k, v in hist.items():
        assert np.all(np.isfinite(v)) and v[-1] < v[0], k


def test_profile_local_rehearsal(capsys):
    """The on-card profiler's control flow, rehearsed on the CPU at a
    small size: every unit runs and no device number is reported."""
    from fpv4d_torch.utils import profile_local
    assert profile_local.main(["--device", "cpu", "--T", "12",
                               "--num-verts", str(V), "--scene-pts", "400",
                               "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] is None and out["P"] == 192
    for unit in ("refresh", "local_a", "local_b", "local_skate"):
        assert out[unit]["wall_ms"] > 0, unit
        assert out[unit]["device_ms"] is None, unit
