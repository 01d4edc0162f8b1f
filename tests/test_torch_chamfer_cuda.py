"""K2 (fpv4d_torch/csrc/chamfer_nn.cu) and its wrapper; no jax, so the
file runs on the card too (README, "PyTorch port (H100)").

On the CPU the wrapper takes the plain version, and only because the
tensors lie on the CPU; the kernel itself runs only on a CUDA card:
those tests carry the `gpu` marker and skip here. On the card the
kernel is held bit-exactly against the plain version: its tensor-core
filter only chooses which points to re-evaluate, and each re-evaluation
is the plain version's difference form without FMA contraction, so no
tolerance is needed. The near-tie cases are those where a filter with
too small a margin would choose a different winner."""
import numpy as np
import pytest
import torch

from fpv4d_torch.ops import chamfer_cuda as K
from fpv4d_torch.utils import observability as OBS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    return torch.device("cuda")


def _clouds(N=100, M=777, seed=0, scale=1.0, B=2):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, N, 3) * scale).astype(np.float32)
    y = (rng.randn(M, 3) * scale).astype(np.float32)
    return x, y


def _launches(fn):
    """fn() under tracing -> (its result, K2's launches counted)."""
    OBS.reset_counts()
    with OBS.tracing():
        out = fn()
        n = OBS.counts().get("k2/cuda", 0)
    OBS.reset_counts()
    return out, n


def test_route_counters_name_the_plain_version_on_the_cpu():
    """nn_index counts k2/plain for CPU tensors while tracing is on, and
    nothing while it is off."""
    x, y = _clouds(7, 40, 26)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    OBS.reset_counts()
    K.nn_index(xt, yt)
    assert OBS.counts() == {}
    with OBS.tracing(True):
        OBS.reset_counts()
        K.nn_distance(xt, yt)
        K.nn_index(xt, yt)
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"k2/plain": 2}


def test_cpu_tensors_take_plain_version():
    x, y = _clouds(30, 64, 14)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    (d, i), n = _launches(lambda: K.nn_index(xt, yt))
    d_p, i_p = K.nn_distance_plain(xt, yt)
    assert n == 0
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


def test_kernel_wrapper_rejects_what_it_does_not_take():
    x, y = _clouds(5, 9, 15)
    with pytest.raises(ValueError):
        K.nn_distance_cuda(torch.as_tensor(x), torch.as_tensor(y))
    with pytest.raises(ValueError):
        K.filter_probe(torch.as_tensor(x[0]), torch.as_tensor(y),
                       torch.zeros(5))
    with pytest.raises(ValueError):
        K.nn_distance(torch.as_tensor(x), torch.zeros(0, 3))
    with pytest.raises(ValueError):
        K.nn_distance_plain(torch.as_tensor(x), torch.zeros(4, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("N,M,scale", [(813, 3001, 1.0), (1, 5, 1.0),
                                       (1000, 2049, 1.0), (129, 300, 40.0),
                                       (129, 1, 1.0), (700, 90, 1.0),
                                       (1, 1, 1.0), (4001, 97, 3.0),
                                       (500, 300_001, 1.0)])
def test_kernel_matches_plain_bit_exactly(cuda_device, N, M, scale):
    x, y = _clouds(N, M, 16, scale)
    y = np.concatenate([y, y[:M // 3]])       # duplicates
    n_eq = min(3, N)
    x[0, :n_eq] = y[:n_eq]                    # exact matches
    xt = torch.as_tensor(x, device=cuda_device)
    yt = torch.as_tensor(y, device=cuda_device)
    (d_k, i_k), n = _launches(lambda: K.nn_distance_cuda(xt, yt))
    d_p, i_p = K.nn_distance_plain(xt, yt)
    assert n == 1
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    xk = xt.clone().requires_grad_(True)
    xp = xt.clone().requires_grad_(True)
    K.nn_distance(xk, yt)[0].sum().backward()
    K.nn_distance_ref(xp, yt)[0].sum().backward()
    assert torch.equal(xk.grad, xp.grad)


def _sphere(n=4000, r=0.37, seed=17):
    """Queries with n points at distance ~r around the first, half of
    them moved by one ulp in one coordinate."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(1, 40, 3) * 0.5).astype(np.float32)
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    y = (x[0, 0] + r * u).astype(np.float32)
    y[::2, 1] = np.nextafter(y[::2, 1], np.float32(-np.inf))
    return x, y


def _ulp_line(k=40):
    """A query with points at r, r + 1 ulp, ... on both sides of it:
    exact ties between mirrored points, near-ties an ulp apart."""
    x = np.array([[[1.5, -0.75, 2.0]]], np.float32)
    steps = [np.float32(0.25)]
    for _ in range(k - 1):
        steps.append(np.nextafter(steps[-1], np.float32(1.0)))
    y = []
    for s in steps[::-1]:
        y += [x[0, 0] + [s, 0, 0], x[0, 0] - [s, 0, 0]]
    return x, np.asarray(y, np.float32)


def _near_tie_case(name):
    if name == "sphere, 1 ulp":
        return _sphere()
    if name == "equidistant, 1 ulp apart":
        return _ulp_line()
    x, y = _clouds(300, 5000, 18)
    if name == "near +-1000":
        return x + 1000.0, np.concatenate([y + 1000.0, y - 1000.0])
    if name == "M not a multiple of the tile":
        return x, y[:1025]
    if name == "N = 1":
        return x[:1, :1], y
    raise KeyError(name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sphere, 1 ulp",
                                  "equidistant, 1 ulp apart",
                                  "near +-1000",
                                  "M not a multiple of the tile", "N = 1"])
def test_kernel_matches_plain_on_near_ties(cuda_device, case):
    x, y = _near_tie_case(case)
    xt = torch.as_tensor(x, device=cuda_device)
    yt = torch.as_tensor(y, device=cuda_device)
    rechecks = torch.zeros(xt.shape[:-1], dtype=torch.int32,
                           device=cuda_device)
    d_k, i_k = K.nn_distance_cuda(xt, yt, rechecks=rechecks)
    d_p, i_p = K.nn_distance_plain(xt, yt)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    assert bool((rechecks >= 1).all())        # every winner is re-checked
    d_n, i_n = K.nn_distance_cuda(xt, yt)     # and the count changes none
    assert torch.equal(d_n, d_k) and torch.equal(i_n, i_k)


@pytest.mark.gpu
def test_kernel_over_a_clip_axis(cuda_device):
    """Clouds [C, M, 3] padded with far points (the fleet's scenes), one
    clip shifted and cut: one launch, each clip bit-exact against the
    [M, 3] launch on its own padded cloud and the plain version, and
    the gradient in x exact."""
    from fpv4d_torch.parallel.multi_clip import pad_scenes
    x, y = _clouds(813, 5000, 22, B=6)
    y1 = y[:3001] + np.float32([0.5, 0.0, 0.25])
    yb = torch.as_tensor(pad_scenes([y, y1]), device=cuda_device)
    xb = torch.as_tensor(np.stack([x[:3], x[3:] + np.float32(0.3)]),
                         device=cuda_device)
    (d_k, i_k), n = _launches(lambda: K.nn_distance_cuda(xb, yb))
    assert n == 1
    d_p, i_p = K.nn_distance_plain(xb, yb)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    assert int(i_k[1].max()) < 3001
    for c in range(2):
        d_c, i_c = K.nn_distance_cuda(xb[c], yb[c])
        assert torch.equal(d_k[c], d_c) and torch.equal(i_k[c], i_c)
    xk = xb.clone().requires_grad_(True)
    xp = xb.clone().requires_grad_(True)
    K.nn_distance(xk, yb)[0].sum().backward()
    K.nn_distance_ref(xp, yb)[0].sum().backward()
    assert torch.equal(xk.grad, xp.grad)


@pytest.mark.gpu
def test_rechecks_must_fit_the_queries(cuda_device):
    x, y = _clouds(5, 9, 19)
    with pytest.raises(ValueError):
        K.nn_distance_cuda(torch.as_tensor(x, device=cuda_device),
                           torch.as_tensor(y, device=cuda_device),
                           rechecks=torch.zeros(3, dtype=torch.int32,
                                                device=cuda_device))


def _cell_inputs(T=300, N=814, g=317, seed=23):
    """The brute cells' shape (perfbench/inputs/synth.py): a 10 m x 10 m
    floor of g x g points at height -1 with 5 cm noise clipped at 3
    sigma, row by row, and T frames of N leg vertices standing on it,
    each frame's legs moved over the floor."""
    rng = np.random.RandomState(seed)
    lin = np.linspace(-5.0, 5.0, g, dtype=np.float32)
    zs, xs = np.meshgrid(lin, lin, indexing="ij")
    noise = np.clip(rng.randn(g * g), -3, 3)
    y = np.stack([xs.ravel(), -1.0 + 0.05 * noise, zs.ravel()],
                 1).astype(np.float32)
    legs = rng.rand(T, N, 3) * [0.6, 1.0, 0.4] + [0.2, -1.05, -0.3]
    move = np.cumsum(rng.randn(T, 1, 3) * [0.02, 0.0, 0.02], 0)
    return (legs + move).astype(np.float32), y


@pytest.mark.gpu
@pytest.mark.parametrize("shuffled", [False, True])
def test_kernel_at_the_cell_shape(cuda_device, shuffled):
    """[300, 814] leg vertices over the 100,489-point floor, stored row
    by row or shuffled: bit-exact, and every query's winner re-checked."""
    x, y = _cell_inputs()
    if shuffled:
        y = y[np.random.RandomState(27).permutation(len(y))]
    xt = torch.as_tensor(x, device=cuda_device)
    yt = torch.as_tensor(y, device=cuda_device)
    rechecks = torch.zeros(xt.shape[:-1], dtype=torch.int32,
                           device=cuda_device)
    (d_k, i_k), n = _launches(
        lambda: K.nn_distance_cuda(xt, yt, rechecks=rechecks))
    assert n == 1
    d_p, i_p = K.nn_distance_plain(xt, yt)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    assert bool((rechecks >= 1).all())
    print(f"re-checks a query: mean {float(rechecks.double().mean()):.3f}"
          f", max {int(rechecks.max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(100, 37), (1, 300), (129, 1)])
def test_kernel_over_a_ragged_clip_axis(cuda_device, sizes):
    """Two clips of ragged clouds, padded to one M (below a stage, or one
    point), 300 queries a clip: one launch, bit-exact, no padding point
    wins."""
    from fpv4d_torch.parallel.multi_clip import pad_scenes
    x, y = _clouds(300, max(sizes), 24, B=2)
    yb = torch.as_tensor(pad_scenes([y[:sizes[0]], y[:sizes[1]] + 0.5]),
                         device=cuda_device)
    xb = torch.as_tensor(x, device=cuda_device)
    (d_k, i_k), n = _launches(lambda: K.nn_distance_cuda(xb, yb))
    assert n == 1
    d_p, i_p = K.nn_distance_plain(xb, yb)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    for c in range(2):
        assert int(i_k[c].max()) < sizes[c]


def _probe_case(name, rng):
    """(queries [256, 3], points [M, 3], -tau per query or None) that
    stress the filter's error: far centres, large |b|, near ties."""
    x = (rng.randn(256, 3) * 0.3).astype(np.float32)
    y = rng.randn(1000, 3).astype(np.float32)
    if name == "far centre":
        x += np.float32(100.0)
        y = (y * 40).astype(np.float32)
    elif name == "large |b|":
        y = (y * 1e3).astype(np.float32)
    elif name == "near ties":
        u = rng.randn(1000, 3)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        y = (x[0] + 0.37 * u).astype(np.float32)
        y[::2, 1] = np.nextafter(y[::2, 1], np.float32(-np.inf))
    elif name == "dead rows":
        x = x[:200]
    return x, y


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unit", "far centre", "large |b|",
                                  "near ties", "dead rows"])
def test_filter_probe_within_the_margin_terms(cuda_device, case):
    """The card's raw wgmma filter values (K.filter_probe, the kernel's
    staging, fragments and product): |F~ - G| <= e_a 2|a||b| + e_b |b|^2
    with no threshold, and with -tau folded in (tau near each row's
    least G, where the sum cancels) |D - (G - tau)| <= the same plus
    1.03 * 2^-16 |tau|, G = |b|^2 - 2 a.b exact from the f32 a and b
    (csrc/chamfer_nn.cu, the margin for tau inside the sum)."""
    from fpv4d_torch.ops import gram_nn
    rng = np.random.RandomState(25)
    x, y = _probe_case(case, rng)
    xt = torch.as_tensor(x, device=cuda_device)
    yt = torch.as_tensor(y, device=cuda_device)
    c = xt[0]
    a = (xt - c).double().cpu()
    b, _ = gram_nn.centred_points(yt, c)
    b = b.double().cpu()
    G = (b ** 2).sum(1)[None] - 2 * a @ b.T
    e_a, e_b = gram_nn.EPS["bf16"]
    terms = (e_a * 2 * a.norm(dim=1)[:, None] * b.norm(dim=1)[None]
             + e_b * b.norm(dim=1)[None] ** 2 + gram_nn.ABS)
    zero = torch.zeros(len(x), device=cuda_device)
    F = K.filter_probe(xt, yt, zero).double().cpu()
    assert bool(((F - G).abs() <= terms).all()), float(
        ((F - G).abs() / terms).max())
    tau = G.min(1).values * (1 + 1e-4 * torch.as_tensor(
        rng.randn(len(x))).double())
    neg = (-tau).float()
    D = K.filter_probe(xt, yt, neg.to(cuda_device)).double().cpu()
    tau = -neg.double()
    err = (D - (G - tau[:, None])).abs()
    bound = terms + 1.03 * 2.0 ** -16 * tau.abs()[:, None]
    assert bool((err <= bound).all()), float((err / bound).max())
    # a value the margin puts below zero comes out negative
    sure = (G - tau[:, None]) < -bound
    assert bool((D[sure] < 0).all())
