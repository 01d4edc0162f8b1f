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

The other modes and contact sources run the same way: 'global' and
'dct' with the grid, 'global' and 'local' with brute force (the
reference's nn_impl="xla"), the exact per-step grid query
(contact_refresh_steps=0) and the floor-SDF collision term.

Tolerances: local_a, local_b, global_a, global_b and dct_b histories
agree to f32 summation order (rtol 1e-4; measured ~5e-6), dct_a's pure
L2 DCT residual to rtol 1e-5. The skate phase's L1 terms meet near-zero
differences, where Adam's per-element normalization turns last-bit
gradient differences into +-lr steps for a few entries: rtol 1e-3 on its
history, and on the final body_6d 99% of entries within 1e-4 and all
within 2*lr. c_dct after the 38 dct_a steps: atol 1e-5 (its entries are
trajectory coefficients of order 1-10, and the summation-order
differences of each step's residual accumulate to ~2e-6); 1e-6 in the
modes that leave it near its start. Brute-force winners may differ from
the reference's Gram-form search among near-ties, at equal exact
distance; the scenario has none that move a history."""
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
from fpv4d.ops import sdf as JSDF
from fpv4d.solve.clip_solve import ClipSolver as JSolver
from fpv4d_torch import convert
from fpv4d_torch.config import ClipConfig as TConfig
from fpv4d_torch.ops import sdf as TSDF
from fpv4d_torch.solve.clip_solve import ClipSolver as TSolver

from helpers import smooth_noise

T, V = 12, 512


def make_scenario():
    """The scenario's arrays (also read by tests/test_torch_step_graph.py)."""
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


@pytest.fixture(scope="module")
def scenario():
    return make_scenario()


def _solvers(sc, nn_impl="grid", sdf=False, **cfg):
    """The reference and the port on one scenario. nn_impl 'brute' is
    the reference's 'xla' (exact brute force; off the TPU it would pick
    it anyway); sdf=True gives both the same floor-plane SDF."""
    base = dict(num_iter=20, num_iter_dct=40, window=T, dct_num=3,
                contact_refresh_steps=4)
    base.update(cfg)
    vids = np.concatenate([sc["vl"], sc["vr"]])
    js = JSolver(model=sc["model"], vposer_params=sc["vp"],
                 scene_verts=sc["scene"], contact_vids=vids,
                 contact_vids_left=sc["vl"], contact_vids_right=sc["vr"],
                 config=JConfig(cand_impl="xla", **base),
                 nn_impl="xla" if nn_impl == "brute" else nn_impl,
                 sdf=JSDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
                 if sdf else None)
    arrays = {k: np.asarray(getattr(sc["model"], k))
              for k in jsmplx.SmplxModel._LEAVES}
    arrays["faces"] = sc["model"].faces
    g = js._grid
    grid = None if g is None else convert.voxel_grid_from_numpy(
        np.asarray(g.cand_pts), np.asarray(g.cand_idx),
        np.asarray(g.origin), g.dims, g.h)
    ts = TSolver(model=convert.smplx_from_numpy(arrays),
                 vposer_params=convert.vposer_from_numpy(
                     {k: np.asarray(v) for k, v in sc["vp"].items()}),
                 scene_verts=sc["scene"], contact_vids=vids,
                 contact_vids_left=sc["vl"], contact_vids_right=sc["vr"],
                 config=TConfig(**base), nn_impl=nn_impl, grid=grid,
                 sdf=TSDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
                 if sdf else None, device="cpu")
    return js, ts


def _fit_both(sc, js, ts, mode):
    jstate, jh = js.fit(jnp.asarray(sc["body"]), jnp.asarray(sc["cam"]),
                        mode=mode)
    tstate, th = ts.fit(sc["body"], sc["cam"], mode=mode)
    assert jh.keys() == th.keys()
    return jstate, jh, tstate, th


def _check_final(jstate, tstate, body_atol=2 * 0.005, dct_atol=1e-6):
    b_t, b_j = tstate.body_6d.numpy(), np.asarray(jstate.body_6d)
    err = np.abs(b_t - b_j)
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= body_atol
    np.testing.assert_allclose(float(tstate.scale), float(jstate.scale),
                               atol=1e-5)
    np.testing.assert_allclose(tstate.camera_ext.numpy(),
                               np.asarray(jstate.camera_ext), atol=1e-6)
    np.testing.assert_allclose(tstate.c_dct.numpy(),
                               np.asarray(jstate.c_dct), atol=dct_atol)


@pytest.mark.parametrize("compact,skate", [(0, 0), (64, 0), (0, 64),
                                           (64, 64)])
def test_local_fit_matches_reference(scenario, compact, skate):
    sc = scenario
    js, ts = _solvers(sc, contact_compact=compact, skate_subset=skate,
                      skate_body_only=bool(skate))
    assert ts._contact_prune is not None      # pruning engages
    if skate:
        np.testing.assert_array_equal(ts._skate_vids, js._skate_vids)
    jstate, jh, tstate, th = _fit_both(sc, js, ts, "local")
    for k, rtol in (("local_a", 1e-4), ("local_b", 1e-4),
                    ("local_skate", 1e-3)):
        assert th[k].shape == jh[k].shape
        np.testing.assert_allclose(th[k], jh[k], rtol=rtol, err_msg=k)
    _check_final(jstate, tstate)
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


# the reference's histories per mode and contact source, with the
# tolerance of each phase (module docstring)
_MODE_CASES = {
    ("global", "grid"): {"global_a": 1e-4, "global_b": 1e-4},
    ("global", "brute"): {"global_a": 1e-4, "global_b": 1e-4},
    ("dct", "grid"): {"dct_a": 1e-5, "dct_b": 1e-4},
    ("local", "brute"): {"local_a": 1e-4, "local_b": 1e-4,
                         "local_skate": 1e-3},
}


@pytest.mark.parametrize("mode,nn_impl", sorted(_MODE_CASES))
def test_mode_fit_matches_reference(scenario, mode, nn_impl):
    sc = scenario
    js, ts = _solvers(sc, nn_impl=nn_impl, contact_compact=64)
    assert (ts.grid is None) == (nn_impl == "brute")
    jstate, jh, tstate, th = _fit_both(sc, js, ts, mode)
    for k, rtol in _MODE_CASES[mode, nn_impl].items():
        assert th[k].shape == jh[k].shape, k
        np.testing.assert_allclose(th[k], jh[k], rtol=rtol, err_msg=k)
    _check_final(jstate, tstate, dct_atol=1e-5 if mode == "dct" else 1e-6)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_exact_grid_query_matches_reference(scenario, mode):
    """contact_refresh_steps=0: the exact per-step voxel query under
    autodiff (grid_min_dist), no candidate tables."""
    sc = scenario
    js, ts = _solvers(sc, contact_refresh_steps=0)
    jstate, jh, tstate, th = _fit_both(sc, js, ts, mode)
    for k in th:
        rtol = 1e-3 if k == "local_skate" else 1e-4
        np.testing.assert_allclose(th[k], jh[k], rtol=rtol, err_msg=k)
    _check_final(jstate, tstate)


@pytest.mark.parametrize("mode,refresh", [("global", 4), ("dct", 0)])
def test_sdf_collision_matches_reference(scenario, mode, refresh):
    """A floor SDF activates the collision term on the contact phases,
    linearized at each refresh (every DEFAULT_REFRESH_STEPS steps when
    contact_refresh_steps is 0)."""
    sc = scenario
    js, ts = _solvers(sc, sdf=True, contact_refresh_steps=refresh)
    jstate, jh, tstate, th = _fit_both(sc, js, ts, mode)
    for k in th:
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, err_msg=k)
    _check_final(jstate, tstate, dct_atol=1e-5 if mode == "dct" else 1e-6)
    tstate0, tt6, tw = ts.init_state(sc["body"], sc["cam"])
    lin = ts._refresh_sdf(tstate0)
    terms = ts.terms(tstate0, tt6, tw, sdf_lin=lin)
    assert float(terms.collision) > 0.0       # the floor is penetrated


def test_dct_only_phase_matches_generic(scenario):
    """dct_a's hoisted runner (joints computed once, without grad) gives
    the losses and the state of stepping phase_loss('dct_a'), which
    recomputes the joints every step: the body is frozen, so they are
    loop-invariant, and the same ops give the same bits."""
    sc = scenario
    _, ts = _solvers(sc)
    runs = []
    for hoisted in (True, False):
        state, t6, fw = ts.init_state(sc["body"], sc["cam"])
        state, opt = ts.make_optimizer(state)
        if hoisted:
            h = ts._run_phase(state, opt, t6, fw, 10, "dct_a")
        else:
            h = ts._run_steps(state, opt, ts.phase_mask("dct_a"), 10,
                              lambda st: ts.phase_loss("dct_a", st, t6, fw))
        runs.append((h, [x.detach().clone() for x in state]))
    (h1, s1), (h2, s2) = runs
    assert torch.equal(h1, h2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


def test_checkpoint_round_trip(scenario, tmp_path):
    from fpv4d_torch.utils import checkpoint as CK
    sc = scenario
    _, ts = _solvers(sc)
    final, hist = ts.fit(sc["body"], sc["cam"], mode="global",
                         checkpoint_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "global_a.pt", "global_b.pt"]
    state, opt_state, step = CK.load_solver_state(
        str(tmp_path / "global_b.pt"))
    assert step == sum(len(v) for v in hist.values()) == 20
    for name, x in final._asdict().items():
        assert torch.equal(state[name], x), name
    # the Adam state loads into a fresh optimizer over the same leaves
    leaves, opt = ts.make_optimizer(final)
    opt.load_state_dict(opt_state)
    assert opt.state_dict()["state"][0]["step"] == 20
    _, _, step_a = CK.load_solver_state(str(tmp_path / "global_a.pt"))
    assert step_a == 16
    assert CK.latest_stage_output(str(tmp_path)) is None


def test_unknown_nn_impl_and_mode_raise(scenario):
    _, ts = _solvers(scenario)
    with pytest.raises(ValueError, match="mode"):
        ts.fit(scenario["body"], scenario["cam"], mode="bogus")
    for impl in ("xla", "pallas", "ref"):
        with pytest.raises(ValueError, match="nn_impl"):
            TSolver(model=ts.model, vposer_params=ts.vposer_params,
                    scene_verts=scenario["scene"],
                    contact_vids=ts.contact_vids,
                    contact_vids_left=ts.contact_vids_left,
                    contact_vids_right=ts.contact_vids_right,
                    config=ts.config, nn_impl=impl, device="cpu")
    with pytest.raises(ValueError):
        TConfig(cand_impl="pallas")


def test_standard_problem_matches_reference(tmp_path):
    """The port's standard problem has the reference's arrays and knobs
    at the same (here reduced) sizes; the reference's model cache goes
    to a temporary directory."""
    from fpv4d.utils.bench_problem import standard_problem as jstd
    from fpv4d_torch.utils.bench_problem import standard_problem as tstd
    # 20 iterations: local_b takes 4 steps (its first loss follows
    # local_a's momentum; over 2 steps the sign of its change is
    # rounding's: lr moved by 1e-9 flips it)
    kw = dict(T=24, num_verts=V, scene_pts=400, num_iter=20,
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
