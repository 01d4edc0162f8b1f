"""The Adam's two routes (fpv4d_torch/solve/adam.py, ops/adam_cuda.py and
csrc/adam_step.cu); no jax, so the file runs on the card too (README,
"PyTorch port (H100)").

On the CPU:
* the plain route is the foreach code as it was before the kernel, bit
  for bit, at the clip solve's, the keypoint fit's and the frame fit's
  leaves, with zero gradients on some leaves;
* CPU leaves take the plain route, counted ``adam/plain`` and never
  ``adam/cuda``, and build no kernel table;
* the kernel's table: its chunks cover every element of every leaf
  once, in leaf order; its rows hold the addresses and sizes of the
  leaves, gradients and moments, for plain leaves and for ``select``'s
  row views (a fleet's clips); leaves it cannot step are refused;
* the kernel's arithmetic, emulated in numpy's f32 operation by
  operation, gives the plain route's bits.

On the card (`gpu`): the kernel bit-equal to the foreach route over 200
steps at the clip solve's four leaves (T = 900), at a fleet's ``select``
views, at the frame fit's leaf and at the keypoint fit's leaves, with
zero gradients on some leaves; at counts far past a solve's; captured in
a CUDA graph and replayed, bit-equal to eager; the route's counter and
launch count, gradients left 0 by the step, and a replaced gradient
refused.
"""
import numpy as np
import pytest
import torch

from fpv4d_torch.ops import adam_cuda as AC
from fpv4d_torch.solve.adam import Adam, foreach_step
from fpv4d_torch.utils import observability as OBS

LR = 0.005          # ClipSolveConfig.lr


def _shapes(T, C=1):
    """The leaf shapes of each Adam of the port at T frames (C clips for
    the keypoint fit)."""
    return {
        # ClipState: body_6d, scale, camera_ext, c_dct (window 60)
        "clip": [(T, 78), (), (T, 4, 4), (max(1, T // 60), 23, 3, 5)],
        # keypoint_fit.LEAVES at the standard model's widths
        "keypoint": [(C, T, n) for n in (3, 3, 10, 32, 12, 12, 3, 10)],
        # frame_fit: fit_independent's x, the sequential fits' x
        "frame": [(T, 78)],
        "frame_seq": [(78,)],
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Adam kernel has no CPU mode)")
    return torch.device("cuda")


def _draws(shapes, steps, seed, device="cpu"):
    """(leaves, per-step gradients) drawn from `seed`: gradients over
    four decades, a leaf's exactly zero in every third step (a masked
    leaf) and the first leaf's in step 5 (a phase that reaches none but
    one), and gradients of 1e-20 in step 7 (subnormal squares)."""
    rng = np.random.RandomState(seed)
    leaves = [torch.tensor(np.asarray(rng.randn(*s), np.float32),
                           device=device) for s in shapes]
    grads = []
    for k in range(steps):
        gs = [np.asarray(rng.randn(*s) * 10.0 ** rng.uniform(-3, 1),
                         np.float32) for s in shapes]
        if k % 3 == 1:
            gs[-1] = np.zeros_like(gs[-1])
        if k == 5:
            gs[0] = np.zeros_like(gs[0])
        if k == 7:
            gs = [np.full_like(g, 1e-20) for g in gs]
        grads.append([torch.tensor(g, device=device) for g in gs])
    return leaves, grads


def _former_step(params, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Adam.step's foreach code as it was before the kernel."""
    g = [p.grad for p in params]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g2)
    count.add_(1)
    bc1 = 1 - torch.pow(b1, count)
    bc2 = 1 - torch.pow(b2, count)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# -- the CPU: the plain route ----------------------------------------------------

@pytest.mark.parametrize("which", ["clip", "keypoint", "frame",
                                   "frame_seq"])
def test_plain_route_is_the_former_code(which):
    """30 steps of Adam (zero_grad, the gradient accumulated as a
    backward does, step) and of the former code on copies: the same
    bits in the leaves, moments and count."""
    shapes = _shapes(12, C=2)[which]
    leaves, grads = _draws(shapes, 30, seed=len(which))
    opt = Adam([x.clone() for x in leaves], LR)
    ref = [x.clone().requires_grad_(True) for x in leaves]
    for p in ref:
        p.grad = torch.zeros_like(p)
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    count = torch.zeros((), dtype=torch.int32)
    for gs in grads:
        opt.zero_grad()
        for p, q, g in zip(opt.params, ref, gs):
            p.grad += g
            q.grad.copy_(g)
        opt.step()
        with torch.no_grad():
            _former_step(ref, mu, nu, count, LR)
    assert int(opt.count) == int(count) == 30
    assert _equal(opt.params, ref) and _equal(opt.mu, mu)
    assert _equal(opt.nu, nu)
    opt.zero_grad()
    assert all(not p.grad.any() for p in opt.params)


def test_cpu_route_counts_plain_and_never_launches(monkeypatch):
    """CPU leaves: no kernel table, `adam/plain` once per step while
    tracing is on, no `adam/cuda` (no launch), no build."""
    def no_build():
        raise AssertionError("the CPU route built the kernel")
    monkeypatch.setattr(AC, "build", no_build)
    leaves, grads = _draws(_shapes(12)["clip"], 3, seed=4)
    opt = Adam([x.clone() for x in leaves], LR)
    assert opt._table is None
    with OBS.tracing():
        OBS.reset_counts()
        for gs in grads:
            opt.zero_grad()
            for p, g in zip(opt.params, gs):
                p.grad += g
            opt.step()
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"adam/plain": 3}
    fleet = Adam([torch.zeros((4,) + s) for s in _shapes(12)["clip"]], LR)
    assert fleet._table is None and fleet.select(slice(0, 2))._table is None


# -- the CPU: the kernel's table ---------------------------------------------------

@pytest.mark.parametrize("sizes", [
    [70200, 1, 14400, 5175],                  # the clip solve at T = 900
    [AC.CHUNK, AC.CHUNK + 1, 1, AC.CHUNK - 1],
    [0, 3, 0],
    [0],
])
def test_chunk_plan_covers_every_element_once(sizes):
    plan = AC.chunk_plan(sizes)
    assert plan.dtype == np.int32 and plan.shape[1] == 2
    seen = [np.zeros(n, np.int64) for n in sizes]
    for leaf, start in plan:
        seen[leaf][start:start + AC.CHUNK] += 1
    assert all((s == 1).all() for s in seen)
    assert list(plan[:, 0]) == sorted(plan[:, 0])
    assert len(plan) == max(1, sum(-(-n // AC.CHUNK) for n in sizes))


def _rows(table):
    return [tuple(int(v) for v in r) for r in table.leaves]


def test_leaf_table_of_plain_leaves():
    """A row per leaf: the addresses of p, its gradient, mu and nu, and
    its element count; the chunks of chunk_plan; a zero ticket."""
    shapes = _shapes(900)["clip"]
    ps = [torch.zeros(s) for s in shapes]
    gs, mu, nu = ([torch.zeros(s) for s in shapes] for _ in range(3))
    table = AC.leaf_table(ps, gs, mu, nu)
    assert table.leaves.dtype == torch.int64
    assert _rows(table) == [(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                             v.data_ptr(), p.numel())
                            for p, g, m, v in zip(ps, gs, mu, nu)]
    assert np.array_equal(table.chunks.numpy(),
                          AC.chunk_plan([p.numel() for p in ps]))
    assert table.ticket.tolist() == [0] and table.ticket.dtype == torch.int32
    assert all(any(t is k for k in table.tensors) for t in ps + gs + mu + nu)


def test_leaf_table_of_select_row_views():
    """select's rows of a fleet's leaves: each row of the table starts
    at the first selected row of the fleet's tensors and counts that
    slice's elements."""
    shapes = [(4,) + s for s in _shapes(12)["clip"]]
    fleet = Adam([torch.zeros(s) for s in shapes], LR)
    sl = slice(1, 3)
    sub = fleet.select(sl)
    table = AC.leaf_table(sub.params, [q.grad for q in sub.params], sub.mu,
                          sub.nu)
    want = []
    for p, m, v in zip(fleet.params, fleet.mu, fleet.nu):
        row = p[0].numel() * 4                 # bytes of one clip's row
        want.append(tuple(t.data_ptr() + sl.start * row
                          for t in (p, p.grad, m, v))
                    + (p[sl].numel(),))
    assert _rows(table) == want


@pytest.mark.parametrize("fault", ["strided", "f64", "shape"])
def test_leaf_table_refuses_what_the_kernel_cannot_step(fault):
    p = torch.zeros(6, 4)
    g, m, v = torch.zeros(6, 4), torch.zeros(6, 4), torch.zeros(6, 4)
    if fault == "strided":
        p = torch.zeros(4, 6).t()
    elif fault == "f64":
        m = m.double()
    else:
        v = torch.zeros(24)
    with pytest.raises(ValueError, match="contiguous f32"):
        AC.leaf_table([p], [g], [m], [v])


def _emulated_step(p, g, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """csrc/adam_step.cu's element arithmetic in numpy f32, one rounded
    operation at a time, with the bias corrections by torch.pow of the
    count and the square root by torch.sqrt, as the foreach route
    computes them on this device (a CPU's torch.sqrt need not round as
    IEEE's does; the card's and __fsqrt_rn do). Returns (p, mu, nu)."""
    f = np.float32
    bc1 = f(1) - torch.pow(b1, count).numpy()
    bc2 = f(1) - torch.pow(b2, count).numpy()
    mu = mu * f(b1) + g * f(1 - b1)
    nu = nu * f(b2) + (g * g) * f(1 - b2)
    den = torch.sqrt(torch.as_tensor(np.asarray(nu / bc2))).numpy() + f(eps)
    upd = ((mu / bc1) / den) * f(-lr)
    return p + upd, mu, nu


def test_kernel_arithmetic_emulated_is_the_plain_route():
    """20 steps of the emulated kernel and of the CPU Adam from the same
    leaves and gradients: the same bits."""
    shapes = _shapes(12)["clip"]
    leaves, grads = _draws(shapes, 20, seed=5)
    opt = Adam([x.clone() for x in leaves], LR)
    em = [(x.numpy().copy(), np.zeros_like(x.numpy()),
           np.zeros_like(x.numpy())) for x in leaves]
    for k, gs in enumerate(grads, start=1):
        for p, g in zip(opt.params, gs):
            p.grad.copy_(g)
        opt.step()
        count = torch.tensor(k, dtype=torch.int32)
        em = [_emulated_step(p, g.numpy(), m, v, count, LR)
              for (p, m, v), g in zip(em, gs)]
    for (p, m, v), a, b, c in zip(em, opt.params, opt.mu, opt.nu):
        assert np.array_equal(p, a.numpy()) and np.array_equal(m, b.numpy())
        assert np.array_equal(v, c.numpy())


# -- the card -------------------------------------------------------------------

def _pair(leaves, dev, lr=LR):
    """(the kernel's Adam, the foreach route's leaves, moments and count)
    from the same leaves on the card."""
    opt = Adam([x.to(dev) for x in leaves], lr)
    ref = [x.to(dev) for x in leaves]
    return opt, (ref, [torch.zeros_like(x) for x in ref],
                 [torch.zeros_like(x) for x in ref],
                 torch.zeros((), dtype=torch.int32, device=dev))


def _step_both(opt, ref, gs, lr=LR):
    """One step of each: the kernel's as the solve takes it (zero_grad,
    the gradient accumulated as a backward does, step)."""
    opt.zero_grad()
    for p, g in zip(opt.params, gs):
        p.grad += g
    opt.step()
    ps, mu, nu, count = ref
    foreach_step(ps, gs, mu, nu, count, lr, 0.9, 0.999, 1e-8)


def _same(opt, ref):
    ps, mu, nu, count = ref
    return (int(opt.count) == int(count) and _equal(opt.params, ps)
            and _equal(opt.mu, mu) and _equal(opt.nu, nu))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["clip", "keypoint", "frame",
                                   "frame_seq"])
def test_kernel_is_the_foreach_route_bit_for_bit(cuda_device, which):
    """200 steps at T = 900: leaves, moments and count equal the foreach
    route's after every step, and every gradient 0 after the step."""
    shapes = _shapes(900)[which]
    leaves, grads = _draws(shapes, 200, seed=11, device=cuda_device)
    opt, ref = _pair(leaves, cuda_device)
    assert opt._table is not None
    for k, gs in enumerate(grads):
        _step_both(opt, ref, gs)
        assert _same(opt, ref), f"{which}: step {k + 1} differs"
        assert all(not p.grad.any() for p in opt.params)


@pytest.mark.gpu
def test_kernel_on_fleet_select_views(cuda_device):
    """A fleet of 4 clips at T = 900, its skate stepped in two chunks of
    2 clips (select's views, each with its own table, from the fleet's
    count): the same bits as the foreach route on the same views."""
    shapes = [(4,) + s for s in _shapes(900)["clip"]]
    leaves, grads = _draws(shapes, 40, seed=12, device=cuda_device)
    opt, ref = _pair(leaves, cuda_device)
    for gs in grads[:10]:
        _step_both(opt, ref, gs)
    count0 = ref[3].clone()
    for c0 in (0, 2):
        sl = slice(c0, c0 + 2)
        sub = opt.select(sl)
        rsub = ([x[sl] for x in ref[0]], [x[sl] for x in ref[1]],
                [x[sl] for x in ref[2]], count0.clone())
        for gs in grads[10:]:
            _step_both(sub, rsub, [g[sl] for g in gs])
        assert _same(sub, rsub)
    opt.count.copy_(sub.count)
    ref[3].copy_(rsub[3])
    assert _same(opt, ref) and int(opt.count) == 40


@pytest.mark.gpu
@pytest.mark.parametrize("count", [9_990, 1_000_000, 2 ** 24 + 1])
def test_kernel_at_counts_past_a_solve(cuda_device, count):
    """From a state loaded at a large count (b^count near 0, and a count
    that f32 rounds): 10 steps, the foreach route's bits."""
    shapes = _shapes(900)["clip"]
    leaves, grads = _draws(shapes, 11, seed=13, device=cuda_device)
    opt, ref = _pair(leaves, cuda_device)
    _step_both(opt, ref, grads[0])
    sd = opt.state_dict()
    sd["state"][0]["step"] = torch.tensor(count, dtype=torch.int32)
    opt.load_state_dict(sd)
    ref[3].fill_(count)
    for gs in grads[1:]:
        _step_both(opt, ref, gs)
        assert _same(opt, ref)
    assert int(opt.count) == count + 10


@pytest.mark.gpu
def test_kernel_captured_and_replayed_is_eager(cuda_device):
    """The clip solve's leaves at T = 900: one eager step, then the step
    captured once and replayed 50 times with new gradients copied in,
    against 51 eager steps: the same bits."""
    shapes = _shapes(900)["clip"]
    leaves, grads = _draws(shapes, 51, seed=14, device=cuda_device)
    eager = Adam([x.clone() for x in leaves], LR)
    graphed = Adam([x.clone() for x in leaves], LR)
    for opt in (eager, graphed):
        for p, g in zip(opt.params, grads[0]):
            p.grad.copy_(g)
        opt.step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed.step()
    assert int(graphed.count) == 1          # the capture ran nothing
    for gs in grads[1:]:
        for opt in (eager, graphed):
            for p, g in zip(opt.params, gs):
                p.grad.copy_(g)
        eager.step()
        graph.replay()
    torch.cuda.synchronize()
    assert int(graphed.count) == int(eager.count) == 51
    assert _equal(graphed.params + graphed.mu + graphed.nu,
                  eager.params + eager.mu + eager.nu)
    assert int(graphed._table.ticket) == 0


@pytest.mark.gpu
def test_kernel_route_counts_and_launches(cuda_device):
    """CUDA leaves: `adam/cuda` once per step while tracing is on (one
    launch a step and none for zero_grad); the gradients 0 from
    construction on; a replaced gradient is refused."""
    leaves, grads = _draws(_shapes(900)["clip"], 3, seed=15,
                           device=cuda_device)
    for p, g in zip(leaves, grads[0]):
        p.requires_grad_(True)
        p.grad = g.clone()
    opt = Adam(leaves, LR)
    assert all(not p.grad.any() for p in opt.params)
    with OBS.tracing():
        OBS.reset_counts()
        for gs in grads:
            opt.zero_grad()
            for p, g in zip(opt.params, gs):
                p.grad += g
            opt.step()
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"adam/cuda": 3}
    opt.params[0].grad = torch.zeros_like(opt.params[0])
    with pytest.raises(RuntimeError, match="replaced"):
        opt.step()
