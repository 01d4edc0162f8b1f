"""Skinning (fpv4d_torch/ops/skin_cuda.py and csrc/lbs_skin.cu); no jax,
so the file runs on the card too (README, "PyTorch port (H100)").

On the CPU:
* the plain route is step 5 of ``SmplxModel.forward`` as it was before
  the kernel (``lbs_weights @ A``, the per-vertex apply, ``transl``),
  bit for bit, values and gradients, on dense and top-4 sparse weights,
  with and without the prune;
* the kernel's arithmetic, emulated on the ELL table and the
  transposed lists in float64, gives the plain version's vertices and
  gradients (the backward's formulas);
* the ELL table and its transpose rebuild the weights exactly.

On the card (`gpu`): the kernel pair against the plain version at the
clip solve's shapes, the forward bit for bit and every gradient within
f32 summation order; two runs give the same bits; a captured graph's
replay equals the eager call bit for bit; the route's counter counts
each launch, forward and backward.
"""
import numpy as np
import pytest
import torch

from fpv4d_torch.models.smplx import synthetic_model
from fpv4d_torch.ops import skin_cuda as S
from fpv4d_torch.utils import observability as OBS

# feet of the synthetic model: the prune keeps the legs
LEG_JOINTS = (7, 8, 10, 11)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the skinning kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models():
    return {sparse: synthetic_model(192, sparse_weights=sparse,
                                    sparse_posedirs=sparse)
            for sparse in (False, True)}


def _leg_vertices(model):
    w = model.lbs_weights.numpy()
    return np.where((w[:, list(LEG_JOINTS)] > 0).any(axis=1))[0]


def _model_table(model, pruned):
    """The model's skinning table of all vertices, or of the vertices on
    the legs pruned to their joints."""
    if not pruned:
        return model._tables(None, None, None)["skin"]
    vids = _leg_vertices(model)
    js, pjs = model.joint_support(vids)
    return model._tables(vids, js, pjs)["skin"]


def former_step5(A, transl, v_posed, weights):
    """Step 5 of SmplxModel.forward before the kernel, as it was."""
    B = A.shape[0]
    Tm = torch.matmul(weights, A).reshape(B, -1, 3, 4)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])],
                       dim=-1)
    verts = torch.einsum("bvpq,bvq->bvp", Tm, v_homo)
    if transl is not None:
        verts = verts + transl[:, None, :]
    return verts


@pytest.mark.parametrize("sparse,pruned", [(False, False), (True, False),
                                           (True, True)],
                         ids=["dense", "top4", "top4_pruned"])
@pytest.mark.parametrize("with_transl", [False, True],
                         ids=["no_transl", "transl"])
def test_plain_route_is_the_former_step(models, sparse, pruned,
                                        with_transl):
    table = _model_table(models[sparse], pruned)
    V, J = table.weights.shape
    A, transl, vp, _ = _random_case(5, V, J, 1, seed=1)
    g = torch.randn(5, V, 3, generator=torch.Generator().manual_seed(9))
    outs = []
    for fn in (lambda a, t, v: S.skin(a, t, v, table),
               lambda a, t, v: former_step5(a, t, v, table.weights)):
        leaves = [x.clone().requires_grad_(True) for x in (A, transl, vp)]
        t = leaves[1] if with_transl else None
        out = fn(leaves[0], t, leaves[2])
        wrt = [leaves[0], leaves[2]] + ([t] if with_transl else [])
        outs.append((out,) + torch.autograd.grad(out, wrt, g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _random_case(B, V, J, K, seed=0, dtype=torch.float32, zero_row=True):
    """A [B, J, 12], transl [B, 3], v_posed [B, V, 3], weights [V, J] with
    K nonzero joints a row (normalised) and, with zero_row, a row of
    none."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, J, 12, generator=g, dtype=dtype) * 0.3
    A.view(B, J, 3, 4)[..., :3] += torch.eye(3, dtype=dtype)
    transl = torch.randn(B, 3, generator=g, dtype=dtype)
    vp = torch.randn(B, V, 3, generator=g, dtype=dtype) * 0.5
    cols = torch.argsort(torch.rand(V, J, generator=g), dim=1)[:, :K]
    w = torch.zeros(V, J, dtype=dtype)
    w.scatter_(1, cols, torch.rand(V, K, generator=g, dtype=dtype) + 0.05)
    # f32 weights whatever the dtype (the table keeps f32 weights)
    w = (w / w.sum(1, keepdim=True)).float().to(dtype)
    if zero_row:
        w[V // 2] = 0
    return A, transl, vp, w


def emulated(A, o, vp, table, g):
    """The kernel pair's arithmetic on the tables, in plain torch:
    (out, d vp, d A, d o) for the cotangent g."""
    B, V = vp.shape[:2]
    J = A.shape[1]
    T = torch.zeros(B, V, 12, dtype=A.dtype)
    for k in range(table.K):
        T = T + table.ell_w[k].to(A.dtype)[None, :, None] * \
            A[:, table.ell_j[k].long()]
    T = T.reshape(B, V, 3, 4)
    out = (T[..., :3] @ vp[..., None])[..., 0] + T[..., 3] + o[:, None]
    dvp = (T[..., :3].transpose(-1, -2) @ g[..., None])[..., 0]
    vh = torch.cat([vp, torch.ones_like(vp[..., :1])], -1)
    dA = torch.zeros(B, J, 12, dtype=A.dtype)
    ptr = table.ptr.tolist()
    for j in range(J):
        v = table.vids[ptr[j]:ptr[j + 1]].long()
        wv = table.vw[ptr[j]:ptr[j + 1]].to(A.dtype)
        dA[:, j] = torch.einsum("v,bvp,bvq->bpq", wv, g[:, v],
                                vh[:, v]).reshape(B, 12)
    return out, dvp, dA, g.sum(1)


@pytest.mark.parametrize("V,J,K", [(300, 55, 4), (120, 12, 12)])
def test_emulated_kernel_matches_the_plain_version(V, J, K):
    A, o, vp, w = _random_case(2, V, J, K, seed=3, dtype=torch.float64)
    table = S.skin_table(w)
    leaves = [t.clone().requires_grad_(True) for t in (A, o, vp)]
    ref = S.skin_plain(leaves[0], leaves[1], leaves[2], w)
    g = torch.randn(ref.shape, dtype=torch.float64)
    dA, do, dvp = torch.autograd.grad(ref, leaves, g)
    out, e_dvp, e_dA, e_do = emulated(A, o, vp, table, g)
    for a, b in ((out, ref), (e_dvp, dvp), (e_dA, dA), (e_do, do)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("V,J,K", [(500, 55, 4), (64, 55, 55), (50, 3, 1)])
def test_tables_rebuild_the_weights(V, J, K):
    *_, w = _random_case(1, V, J, K, seed=4)
    t = S.skin_table(w)
    assert t.K == K and t.ell_j.dtype == torch.int32
    ell = torch.zeros_like(w)
    rows = torch.arange(V)
    for k in range(t.K):
        ell[rows, t.ell_j[k].long()] += t.ell_w[k]
    assert torch.equal(ell, w)
    tr = torch.zeros_like(w)
    ptr = t.ptr.tolist()
    assert ptr[0] == 0 and ptr[-1] == int((w != 0).sum())
    for j in range(J):
        v = t.vids[ptr[j]:ptr[j + 1]].long()
        assert torch.all(v[1:] > v[:-1])           # vertex order
        tr[v, j] = t.vw[ptr[j]:ptr[j + 1]]
    assert torch.equal(tr, w)
    # each row's joints ascending, then padding at weight 0
    for k in range(1, t.K):
        real = t.ell_w[k] != 0
        assert torch.all(t.ell_j[k][real] > t.ell_j[k - 1][real])


def test_model_tables_hold_the_subset_weights(models):
    model = models[True]
    vids = _leg_vertices(model)
    js, _ = model.joint_support(vids)
    table = _model_table(model, pruned=True)
    want = model.lbs_weights[torch.as_tensor(vids)][
        :, torch.as_tensor(js).long()]
    assert torch.equal(table.weights, want) and table.K <= 4


def test_cpu_route_counts_plain_and_never_launches():
    A, transl, vp, w = _random_case(2, 40, 10, 4, seed=5)
    table = S.skin_table(w)
    with OBS.tracing():
        OBS.reset_counts()
        out = S.skin(A, transl, vp, table)
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"skin/plain": 1}
    assert torch.equal(out, S.skin_plain(A, transl, vp, w))
    with pytest.raises(ValueError, match="CUDA"):
        S.skin_cuda_forward(A, transl, vp, table)


# -- on the card -----------------------------------------------------------

# (B, V, J, K): the full mesh, the contact set pruned to the legs (900
# and 300 frames), the skate subset, a dense table
CARD_SHAPES = [(300, 10475, 55, 4), (900, 814, 12, 4), (300, 814, 12, 4),
               (900, 1024, 23, 4), (64, 2048, 55, 55)]


def _card_case(B, V, J, K, dev, seed=0):
    return [t.to(dev) for t in _random_case(B, V, J, K, seed=seed)]


def _grads(fn, A, transl, vp, g):
    leaves = [t.clone().requires_grad_(True) for t in (A, transl, vp)]
    out = fn(*leaves)
    return (out.detach(),) + torch.autograd.grad(out, leaves, g)


@pytest.mark.gpu
@pytest.mark.parametrize("B,V,J,K", CARD_SHAPES)
def test_kernel_matches_plain(cuda_device, B, V, J, K):
    torch.backends.cuda.matmul.allow_tf32 = False
    A, transl, vp, w = _card_case(B, V, J, K, cuda_device)
    table = S.skin_table(w)
    g = torch.randn(B, V, 3, device=cuda_device)
    got = _grads(lambda a, t, v: S.skin(a, t, v, table), A, transl, vp, g)
    ref = _grads(lambda a, t, v: S.skin_plain(a, t, v, w), A, transl, vp, g)
    assert torch.isfinite(got[0]).all()
    # the forward in the library chain's order, its bits; the gradients'
    # sums over up to V vertices in another order than cuBLAS's, within a
    # few ulps of each output's largest entry
    assert torch.equal(got[0], ref[0])
    for name, a, b in zip(("dA", "dtransl", "dvp"), got[1:], ref[1:]):
        err = float((a - b).abs().max())
        assert err <= 2e-5 * float(b.abs().max()), (name, err)


@pytest.mark.gpu
def test_kernel_takes_permuted_tensors(cuda_device):
    # dense tensors whose strides are not [B, V, 3]'s row-major ones: the
    # kernel reads and writes its own contiguous copies
    A, transl, vp, w = _card_case(300, 814, 12, 4, cuda_device)
    table = S.skin_table(w)
    vp = vp.transpose(0, 1).contiguous().transpose(0, 1)
    g = torch.randn(814, 300, 3, device=cuda_device).transpose(0, 1)
    assert not vp.is_contiguous() and not g.is_contiguous()
    got = _grads(lambda a, t, v: S.skin(a, t, v, table), A, transl, vp, g)
    ref = _grads(lambda a, t, v: S.skin_plain(a, t, v, w), A, transl, vp, g)
    assert torch.equal(got[0], ref[0])
    for name, a, b in zip(("dA", "dtransl", "dvp"), got[1:], ref[1:]):
        err = float((a - b).abs().max())
        assert err <= 2e-5 * float(b.abs().max()), (name, err)


@pytest.mark.gpu
def test_kernel_runs_give_the_same_bits(cuda_device):
    A, transl, vp, w = _card_case(300, 10475, 55, 4, cuda_device)
    table = S.skin_table(w)
    g = torch.randn(300, 10475, 3, device=cuda_device)
    fn = lambda a, t, v: S.skin(a, t, v, table)
    one = _grads(fn, A, transl, vp, g)
    two = _grads(fn, A, transl, vp, g)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda_device):
    A, transl, vp, w = _card_case(900, 814, 12, 4, cuda_device)
    table = S.skin_table(w)
    leaves = [t.clone().requires_grad_(True) for t in (A, transl, vp)]
    g = torch.randn(900, 814, 3, device=cuda_device)

    def step():
        out = S.skin(*leaves, table)
        return (out,) + torch.autograd.grad(out, leaves, g)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = [t.clone() for t in step()]
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(captured, eager)]
    # free the graph now: one left to the collector could be reset inside
    # a later test's capture, which invalidates that capture
    del captured
    graph.reset()
    assert all(same), same


@pytest.mark.gpu
def test_launch_count_moves(cuda_device):
    A, transl, vp, w = _card_case(4, 100, 10, 4, cuda_device)
    table = S.skin_table(w)
    A.requires_grad_(True)
    with OBS.tracing():
        OBS.reset_counts()
        S.skin(A, transl, vp, table).sum().backward()
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"skin/cuda": 2}
    with pytest.raises(ValueError):
        S.skin_cuda_forward(A.detach()[:, :5], None, vp, table)
