"""The rest of the port's library against the JAX package on
numpy-seeded inputs: the CVAE (models/cvae.py), the Gram-form chamfer
oracle (ops/chamfer_ref.py), the fitting monitor (utils/monitor.py) and
observability (utils/observability.py).

Tolerances: the CVAE is f32 matmuls and transcendentals in another
summation order, O(1) values: rtol 1e-5 with atol 1e-6 (outputs) and
1e-5 (gradients). Gram-form distances round by a few ulps of |x|^2 +
|y|^2: rtol 1e-5, atol 1e-5 for coordinates of O(1); indices are held
equal wherever the runner-up is farther by more than 1e-4. The monitor
is the same NumPy code: equal results."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.models import cvae as jcvae
from fpv4d.ops import chamfer_ref as jcr
from fpv4d.utils import monitor as jmon
from fpv4d_torch import convert
from fpv4d_torch.models import cvae as tcvae
from fpv4d_torch.ops import chamfer_ref as tcr
from fpv4d_torch.utils import monitor as tmon
from fpv4d_torch.utils import observability as obs

# ---- CVAE ------------------------------------------------------------------

B = 6


def _cvae_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, tcvae.N_DIM_BODY).astype(np.float32),
            rng.randn(B, tcvae.N_DIM_SCENE).astype(np.float32),
            rng.randn(B, tcvae.LATENT_D).astype(np.float32))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_cvae_random_params_equal_the_reference():
    jp = jcvae.random_params(seed=2)
    tp = tcvae.random_params(seed=2)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    cp = convert.cvae_params({k: np.asarray(v) for k, v in jp.items()})
    assert all(torch.equal(cp[k], tp[k]) for k in tp)


def test_cvae_encode_decode_forward_kl():
    jp = jcvae.random_params(seed=0)
    tp = tcvae.random_params(seed=0)
    x, zs, eps = _cvae_inputs()
    mu_j, ls_j = jcvae.encode(jp, jnp.asarray(x), jnp.asarray(zs))
    mu_t, ls_t = tcvae.encode(tp, _t(x), _t(zs))
    for a, b in ((mu_t, mu_j), (ls_t, ls_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    dj = jcvae.decode(jp, jnp.asarray(eps), jnp.asarray(zs))
    dt = tcvae.decode(tp, _t(eps), _t(zs))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    fj = jcvae.forward(jp, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(zs))
    ft = tcvae.forward(tp, _t(x), _t(eps), _t(zs))
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(tcvae.kl_loss(ft[1], ft[2])),
                               float(jcvae.kl_loss(fj[1], fj[2])),
                               rtol=1e-5)


def test_cvae_training_step_gradients():
    """One step's loss (reconstruction + KL) and its gradient in every
    weight, against jax.grad."""
    jp = jcvae.random_params(seed=1)
    x, zs, eps = _cvae_inputs(seed=1)

    def jloss(p):
        rec, mu, ls = jcvae.forward(p, jnp.asarray(x), jnp.asarray(eps),
                                    jnp.asarray(zs))
        return jnp.mean((rec - x) ** 2) + jcvae.kl_loss(mu, ls)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in tcvae.random_params(seed=1).items()}
    rec, mu, ls = tcvae.forward(tp, _t(x), _t(eps), _t(zs))
    lt = ((rec - _t(x)) ** 2).mean() + tcvae.kl_loss(mu, ls)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gj[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_cvae_dropout():
    """No generator: the identity. With one: after each of the first two
    decoder layers a unit is kept with probability 1 - p and scaled by
    1 / (1 - p). The weights make both layers pass a constant c through
    (the second adds -0 to its residual), and the output layer copies
    the hidden units out, so each output is 0 or c / (1 - p)^2."""
    p, L = 0.25, tcvae.LATENT_D
    tp = tcvae.random_params(seed=0)
    x, zs, eps = _cvae_inputs()
    np.testing.assert_array_equal(
        tcvae.decode(tp, _t(eps), _t(zs), 0.5).numpy(),
        tcvae.decode(tp, _t(eps), _t(zs)).numpy())
    tp["dec_fc1_w"].zero_()
    tp["dec_fc1_b"].fill_(1.0)
    tp["dec_fc2_w"].zero_()
    tp["dec_fc2_b"].fill_(-200.0)             # swish(-200) = -0 in f32
    tp["dec_fc3_w"].zero_()
    tp["dec_fc3_w"][:, :L] = torch.eye(L)
    n = 4000
    z = torch.zeros(n, L)
    s = torch.zeros(n, tcvae.N_DIM_SCENE)
    out = tcvae.decode(tp, z, s, p, generator=torch.Generator().manual_seed(0))
    h = out[:, :L]
    c = 1.0 * torch.sigmoid(torch.tensor(1.0))
    kept = h != 0
    keep = 1.0 - p
    assert abs(float(kept.float().mean()) - keep ** 2) < 0.01
    np.testing.assert_allclose(h[kept].numpy(), float(c) / keep ** 2,
                               rtol=1e-6)
    again = tcvae.decode(tp, z, s, p,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


# ---- chamfer_ref -------------------------------------------------------------

def _clouds(seed=0, Q=(3, 250), M=777):
    rng = np.random.RandomState(seed)
    return (rng.randn(*Q, 3).astype(np.float32),
            rng.randn(M, 3).astype(np.float32))


def _clear(x, y):
    """Queries x [..., N, 3] whose runner-up in y [..., M, 3] (batch
    dims broadcast) is farther than the winner by > 1e-4."""
    d = ((x[..., :, None, :].astype(np.float64) - y[..., None, :, :])
         ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] > 1e-4


def test_pairwise_sqdist_and_nn_distance_ref():
    x, y = _clouds()
    xb = x[:, :40]
    yb = np.stack([y[:90], y[90:180], y[180:270]])
    d_t = tcr.pairwise_sqdist(_t(xb), _t(yb)).numpy()
    d_j = np.asarray(jcr.pairwise_sqdist(jnp.asarray(xb), jnp.asarray(yb)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
    for yy in (yb, y[None]):                     # batched and broadcast
        dt, it = tcr.nn_distance_ref(_t(xb), _t(yy))
        dj, ij = jcr.nn_distance_ref(jnp.asarray(xb), jnp.asarray(yy))
        assert it.dtype == torch.int32
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5)
        assert (dt.numpy() >= 0).all()
        clear = _clear(xb, yy)
        assert clear.mean() > 0.95
        np.testing.assert_array_equal(it.numpy()[clear],
                                      np.asarray(ij)[clear])


@pytest.mark.parametrize("qc,sc", [(300, 128), (64, 100), (8192, 8192)])
def test_nn_distance_chunked(qc, sc):
    """Chunks that divide neither size (Q = 750, M = 777), against the
    unchunked oracle and the reference's chunked scan."""
    x, y = _clouds(seed=1)
    dt, it = tcr.nn_distance_chunked(_t(x), _t(y), qc, sc)
    assert dt.shape == x.shape[:-1] and it.dtype == torch.int32
    dr, ir = tcr.nn_distance_ref(_t(x), _t(y))
    dj, ij = jcr.nn_distance_chunked(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(dt.numpy(), dr.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    clear = _clear(x, y)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(it.numpy()[clear], ir.numpy()[clear])
    np.testing.assert_array_equal(it.numpy()[clear], np.asarray(ij)[clear])


def test_chunked_ties_take_the_first_copy():
    """A scene holding every point twice, the copies in other chunks:
    each query's winner is the first copy (an earlier chunk keeps its
    winner, and within a chunk the smallest index wins); a query equal
    to a scene point finds it at distance 0."""
    x, y = _clouds(seed=2, Q=(200,), M=300)
    x[:20] = y[100:120]
    y2 = np.concatenate([y, y])
    for sc in (128, 300, 1000):
        d, i = tcr.nn_distance_chunked(_t(x), _t(y2), 64, sc)
        assert (i.numpy() < 300).all(), sc
        np.testing.assert_array_equal(i.numpy()[:20], np.arange(100, 120))
        assert (d.numpy()[:20] < 1e-5).all()
    d1, i1 = tcr.nn_distance_chunked(_t(x), _t(y), 64, 128)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())


def test_chamfer_ref_four_tuple():
    x, y = _clouds(seed=3, Q=(2, 60), M=90)
    yb = np.stack([y, y[::-1].copy()])
    got = tcr.chamfer_ref(_t(x), _t(yb))
    want = jcr.chamfer_ref(jnp.asarray(x), jnp.asarray(yb))
    for k, (a, b) in enumerate(zip(got, want)):
        if k < 2:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert a.dtype == torch.int32
            clear = (_clear(x, yb) if k == 2 else
                     _clear(yb, x))
            np.testing.assert_array_equal(a.numpy()[clear],
                                          np.asarray(b)[clear])


# ---- monitor -----------------------------------------------------------------

def _histories():
    rng = np.random.RandomState(0)
    geo = 10.0 * 0.9 ** np.arange(50)
    flat = np.concatenate([geo[:20], np.full(10, geo[19])])
    noisy = np.abs(rng.randn(40)) + 1.0
    nan = geo.copy()
    nan[17] = np.nan
    inf = geo.copy()
    inf[3] = np.inf
    return {"geometric": geo, "plateau": flat, "noisy": noisy, "nan": nan,
            "inf": inf, "one": geo[:1], "empty": geo[:0],
            "stall": np.asarray([1.0, 1.0 + 1e-10, 0.5])}


@pytest.mark.parametrize("name", sorted(_histories()))
@pytest.mark.parametrize("ftol,maxiters", [(2e-9, 100_000), (1e-2, 100_000),
                                           (2e-9, 7)])
def test_monitor_matches_the_reference(name, ftol, maxiters):
    h = _histories()[name]
    mons = [m.FittingMonitor(ftol=ftol, maxiters=maxiters)
            for m in (jmon, tmon)]
    for mon in mons:
        mon.stops = [i for i, v in enumerate(h) if mon.update(v)][:1]
    assert [(m.steps, m.stopped_reason, m.stops) for m in mons][0] == \
        [(m.steps, m.stopped_reason, m.stops) for m in mons][1]
    fresh = [m.FittingMonitor(ftol=ftol) for m in (jmon, tmon)]
    assert fresh[0].check_history(h) == fresh[1].check_history(h)
    assert fresh[0].stopped_reason == fresh[1].stopped_reason
    assert (jmon.steps_until_converged(h, ftol)
            == tmon.steps_until_converged(h, ftol))
    assert tmon.rel_change(3.0, 2.0) == jmon.rel_change(3.0, 2.0)


# ---- observability -----------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    with obs.trace(str(tmp_path / "prof")) as path:
        a = torch.randn(64, 64)
        (a @ a).sum()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_nan_debugging_raises_and_restores():
    x = torch.zeros(3, requires_grad=True)
    for prev in (False, True):
        torch.autograd.set_detect_anomaly(prev)
        try:
            with obs.nan_debugging():
                assert torch.is_anomaly_enabled()
                with pytest.raises(RuntimeError, match="nan"):
                    (torch.sqrt(x) * 0.0).sum().backward()
            assert torch.is_anomaly_enabled() == prev
        finally:
            torch.autograd.set_detect_anomaly(False)
    obs.debug_nans(True)
    assert torch.is_anomaly_enabled()
    obs.debug_nans(False)
    assert not torch.is_anomaly_enabled()


def test_checked():
    x = torch.tensor([1.0, 0.0, 4.0])
    out = obs.checked(lambda t: {"a": (t * 2, t.long())}, x)
    assert torch.equal(out["a"][0], x * 2)
    with pytest.raises(FloatingPointError):
        obs.checked(lambda t: (t, torch.log(t - 1.0) * 0.0), x)
    with pytest.raises(FloatingPointError):
        obs.checked(torch.div, x, 0.0)               # +inf and nan
    with pytest.raises(IndexError):
        obs.checked(lambda t: t[torch.tensor([5])], x)
    with pytest.raises(RuntimeError):
        obs.checked(torch.floor_divide, x.long(), torch.zeros(3).long())


def test_stage_timer():
    timer = obs.StageTimer(verbose=False)
    x = torch.ones(4)
    for _ in range(2):
        with timer.stage("a", sync_on=x):
            x = x * 2
    with timer.stage("b"):
        pass
    assert len(timer.records["a"]) == 2 and len(timer.records["b"]) == 1
    s = timer.summary()
    assert s["a"] == sum(timer.records["a"]) and s["b"] >= 0


# ---- synthetic segments and the model cache ----------------------------------

def test_write_synthetic_segments(tmp_path):
    from fpv4d.ops import contact as jcontact
    from fpv4d_torch.ops import contact as tcontact
    jcontact.write_synthetic_segments(str(tmp_path / "j"), 300, seed=2)
    tcontact.write_synthetic_segments(str(tmp_path / "t"), 300, seed=2)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == len(tcontact.ALL_PARTS)
    for n in names:
        assert (json.loads((tmp_path / "t" / n).read_text())
                == json.loads((tmp_path / "j" / n).read_text())), n
    vids, _ = tcontact.load_contact_ids(str(tmp_path / "t"),
                                        tcontact.CLIP_SOLVE_PARTS)
    want = np.concatenate([tcontact.synthetic_segments(300, 2)[p]
                           for p in tcontact.CLIP_SOLVE_PARTS])
    np.testing.assert_array_equal(vids, want)


def test_cached_synthetic_model(tmp_path):
    """The reference's file name; the reference's cached arrays; read
    back from the file the second time, landmarks included; a seed other
    than 0 in a file of its own."""
    from fpv4d.models import smplx as jsmplx
    from fpv4d.utils import bench_problem as jbp
    from fpv4d_torch.models import smplx as tsmplx
    from fpv4d_torch.utils import bench_problem as tbp
    jm = jbp.cached_synthetic_model(200, str(tmp_path / "j"))
    tm = tbp.cached_synthetic_model(200, str(tmp_path / "t"))
    assert (sorted(p.name for p in (tmp_path / "t").iterdir())
            == sorted(p.name for p in (tmp_path / "j").iterdir())
            == ["synthmodel_200_swl.npz"])
    again = tbp.cached_synthetic_model(200, str(tmp_path / "t"))
    fresh = tsmplx.synthetic_model(200, seed=0, sparse_weights=True)
    for k in jsmplx.SmplxModel._LEAVES:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), k)
        assert torch.equal(getattr(again, k), getattr(fresh, k)), k
    np.testing.assert_array_equal(again.faces, jm.faces)
    np.testing.assert_array_equal(again.lmk_faces_idx, fresh.lmk_faces_idx)
    np.testing.assert_array_equal(again.lmk_bary_coords,
                                  fresh.lmk_bary_coords)
    other = tbp.cached_synthetic_model(200, str(tmp_path / "t"), seed=1)
    assert (tmp_path / "t" / "synthmodel_200_s1_swl.npz").exists()
    assert not torch.equal(other.v_template, again.v_template)
