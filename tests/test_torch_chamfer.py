"""K2 (fpv4d_torch/csrc/chamfer_nn.cu): its plain version, its wrapper
and nn.nn_brute, against the JAX package: the Pallas kernel in interpret
mode (as tests/test_chamfer.py runs it) and nn.nn_brute with impl
"xla".

Tolerances and why:
  * the plain version computes each pair's difference form in f32, so
    its distance is the f32 rounding of the true minimum: rtol 1e-6
    against a float64 search;
  * the Pallas kernel selects and measures with the folded Gram form in
    bf16x3 emulation (~2^-16 relative), so its distances agree within
    atol 1e-3, rtol 1e-4 (2e-2 / 2e-3 at 20x coordinates, as
    tests/test_chamfer.py holds it);
  * winners may differ among near-ties (the reference's Gram form and
    the port's difference form round differently): indices are compared
    only where the runner-up is farther by more than 1e-4 (1 + d);
  * gradients: the same formula on the same winner, rtol 1e-5.

The kernel itself and its wrapper are tested in
tests/test_torch_chamfer_cuda.py, which imports no jax."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpv4d.ops import chamfer_pallas as JCP
from fpv4d.ops import nn as JNN
from fpv4d_torch.ops import chamfer_cuda as K
from fpv4d_torch.ops import nn as TNN

INTERP = dict(interpret=True, tile_q=128, tile_m=256)


def _clouds(N=100, M=777, seed=0, scale=1.0, B=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, 3) * scale).astype(np.float32)
    y = (rng.randn(M, 3) * scale).astype(np.float32)
    return x, y


def _truth(x, y):
    """float64 (min, argmin, runner-up gap) per query."""
    d = ((x.reshape(-1, 1, 3).astype(np.float64) - y[None]) ** 2).sum(-1)
    order = np.sort(d, axis=1)
    gap = (order[:, 1] - order[:, 0]) if d.shape[1] > 1 else \
        np.full(d.shape[0], np.inf)
    shape = x.shape[:-1]
    return (order[:, 0].reshape(shape), d.argmin(1).reshape(shape),
            gap.reshape(shape))


def _clear(dmin, gap):
    return gap > 1e-4 * (1.0 + dmin)


@pytest.mark.parametrize("N,M,scale,seed", [
    (100, 777, 1.0, 1),        # random clouds
    (1, 5, 1.0, 2),            # sizes that are multiples of no tile
    (129, 257, 1.0, 3),
    (7, 1000, 1.0, 4),
    (64, 300, 20.0, 5),        # large coordinates
])
def test_plain_matches_interpret_kernel(N, M, scale, seed):
    x, y = _clouds(N, M, seed, scale)
    d, i = K.nn_distance_plain(torch.as_tensor(x), torch.as_tensor(y))
    assert d.shape == x.shape[:-1] and i.dtype == torch.int32
    dmin, amin, gap = _truth(x, y)
    np.testing.assert_allclose(d.numpy(), dmin, rtol=1e-6, atol=1e-12)
    clear = _clear(dmin, gap)
    np.testing.assert_array_equal(i.numpy()[clear], amin[clear])
    d_pl, i_pl = JCP.nn_distance(jnp.asarray(x), jnp.asarray(y), **INTERP)
    tol = dict(atol=2e-2, rtol=2e-3) if scale > 1 else dict(atol=1e-3,
                                                            rtol=1e-4)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_pl), **tol)
    np.testing.assert_array_equal(i.numpy()[clear],
                                  np.asarray(i_pl)[clear])


def test_exact_matches_and_duplicates_tie_to_smallest_index():
    _, y = _clouds(1, 50, 6)
    y = np.concatenate([y, y[:20], y])        # every point repeated
    x = y[[3, 10, 49, 60]][None].copy()       # queries equal to points
    d, i = K.nn_distance_plain(torch.as_tensor(x), torch.as_tensor(y))
    assert np.all(d.numpy() == 0.0)
    assert i.numpy().tolist() == [[3, 10, 49, 10]]
    _, i_pl = JCP.nn_distance(jnp.asarray(x), jnp.asarray(y), **INTERP)
    assert np.asarray(i_pl).tolist() == [[3, 10, 49, 10]]


def test_far_queries():
    x, y = _clouds(40, 300, 7)
    x = x * 50.0 + 300.0                      # far outside the cloud
    d, i = K.nn_distance_plain(torch.as_tensor(x), torch.as_tensor(y))
    dmin, amin, gap = _truth(x, y)
    np.testing.assert_allclose(d.numpy(), dmin, rtol=1e-6)
    clear = _clear(dmin, gap)
    np.testing.assert_array_equal(i.numpy()[clear], amin[clear])


def test_plain_chunks_agree_with_one_block(monkeypatch):
    x, y = _clouds(90, 333, 8)
    d1, i1 = K.nn_distance_plain(torch.as_tensor(x), torch.as_tensor(y))
    monkeypatch.setattr(K, "_PLAIN_ELEMS", 333 * 7)    # 7 queries a chunk
    d2, i2 = K.nn_distance_plain(torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(d1, d2) and torch.equal(i1, i2)


@pytest.mark.parametrize("fn", ["nn_distance", "nn_brute"])
def test_gradients_match_reference_vjp(fn):
    """dx and dy of the port's nn_distance and nn_brute against the
    reference's custom VJPs (nn_brute with impl "xla"), weighted by a
    random cotangent; the cloud has duplicates, so dy sums several
    queries onto one row."""
    x, y = _clouds(60, 200, 9)
    y[100:110] = y[:10]
    g = np.random.RandomState(10).randn(*x.shape[:-1]).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    if fn == "nn_distance":
        d, i = K.nn_distance(xt, yt)
        jfun = lambda a, b: JCP.nn_distance(a, b, **INTERP)  # noqa: E731
    else:
        d, i = TNN.nn_brute(xt, yt)
        jfun = lambda a, b: JNN.nn_brute(a, b, "xla")         # noqa: E731
    (d * torch.as_tensor(g)).sum().backward()
    (jd, ji), vjp = jax.vjp(jfun, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # the Pallas kernel's own distance is the Gram form (bf16x3);
    # nn_brute re-evaluates exactly at the winner in both packages
    tol = (dict(atol=1e-3, rtol=1e-4) if fn == "nn_distance"
           else dict(rtol=1e-5, atol=1e-7))
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), **tol)
    jdx, jdy = vjp((jnp.asarray(g), np.zeros(ji.shape, jax.dtypes.float0)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jdy), rtol=1e-5,
                               atol=1e-6)


def test_nn_brute_matches_reference_xla():
    x, y = _clouds(80, 400, 11, scale=3.0)
    d, i = TNN.nn_brute(torch.as_tensor(x), torch.as_tensor(y))
    jd, ji = JNN.nn_brute(jnp.asarray(x), jnp.asarray(y), "xla")
    dmin, _, gap = _truth(x, y)
    clear = _clear(dmin, gap)
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])
    # both re-evaluate exactly at their winner
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(d.numpy(), dmin, rtol=1e-6)


def test_brute_scene_without_grad_gets_none():
    x, y = _clouds(10, 50, 12)
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y)
    TNN.nn_brute(xt, yt)[0].sum().backward()
    assert yt.grad is None and xt.grad is not None


@pytest.mark.parametrize("shared", [True, False])
def test_chamfer_tuple_matches_reference(shared):
    x, y = _clouds(50, 70, 13)
    if shared:
        yb = y
    else:
        yb = np.stack([y, y[::-1] + 0.1]).astype(np.float32)
    got = K.chamfer(torch.as_tensor(x), torch.as_tensor(yb))
    want = JCP.chamfer(jnp.asarray(x), jnp.asarray(yb), **INTERP)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    for k in (0, 1):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-4)
    if shared:
        dmin, _, gap = _truth(x, y)
        clear = _clear(dmin, gap)
        np.testing.assert_array_equal(got[2].numpy()[clear],
                                      np.asarray(want[2])[clear])


def test_plain_over_a_clip_axis_matches_per_clip_calls():
    """Clouds [C, M, 3] (padded as the fleet pads its scenes): each clip
    searches its own cloud, indices are per clip, the far padding never
    wins, and values and gradients in x and y equal per-clip calls."""
    from fpv4d_torch.parallel.multi_clip import pad_scenes
    rng = np.random.RandomState(21)
    x = rng.randn(2, 3, 40, 3).astype(np.float32)
    y = pad_scenes([rng.randn(300, 3).astype(np.float32),
                    rng.randn(200, 3).astype(np.float32) + 0.5])
    g = torch.as_tensor(rng.randn(2, 3, 40).astype(np.float32))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    d, i = K.nn_distance(xt, yt)
    assert d.shape == i.shape == (2, 3, 40)
    assert int(i[1].max()) < 200                   # padding never wins
    (d * g).sum().backward()
    for c in range(2):
        xc = torch.tensor(x[c], requires_grad=True)
        yc = torch.tensor(y[c], requires_grad=True)
        dc, ic = K.nn_distance(xc, yc)
        (dc * g[c]).sum().backward()
        assert torch.equal(d[c].detach(), dc.detach())
        assert torch.equal(i[c], ic)
        assert torch.equal(xt.grad[c], xc.grad)
        assert torch.equal(yt.grad[c], yc.grad)
    d_n, i_n = TNN.nn_brute(xt.detach(), yt.detach())
    assert torch.equal(d_n, d.detach()) and torch.equal(i_n, i)
    dmin, _, _ = _truth(x[1], y[1][:200])
    np.testing.assert_allclose(d[1].detach().numpy(), dmin, rtol=1e-6)
    with pytest.raises(ValueError, match="same C"):
        K.nn_distance(xt[:1], yt)
