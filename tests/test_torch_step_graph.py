"""The compiled phase: solve/adam.py and solve/step_graph.py.

* the Adam against optax.adam on the same numpy-seeded leaves and
  gradients for 20 steps (rtol 1e-6: the same operations in the same
  order; measured ~1.5e-7 against XLA's CPU code);
* a sync guard (a TorchDispatchMode raising on every op that reads a
  value back to the host or has a data-dependent shape) around the
  captured step of every phase, the capture stood in for on the CPU:
  local_a on the lazy tables and on the exact grid, local_b, skate,
  global_a on brute force, global_b, dct_a, dct_b, and the fleet's
  chunked skate;
* the graph route's plumbing (warm-up, capture, replays, staged tables
  and linearizations through a phase's chunks, the fleet's chunks), with
  a stand-in whose replay reruns the captured step: bit-equal to the
  eager route;
* the eager phase program's histories and final state against the JAX
  package, at tests/test_torch_clip_solve.py's tolerances;
* the Adam state through utils/checkpoint.py resuming a solve to the
  same result;
* launch accounting, through the route counters under tracing
  (utils/observability.py): replays x what one captured call counted,
  the capture itself not counted, for a call, a segment and a refresh;
  a capture made with tracing off keeps its step's counts all the same,
  and its replays add them while tracing is on;
* the segment (PhaseProgram.segment, a frames rank's pieces between its
  collectives): outputs and input gradients bit-equal to plain autograd
  over warm-up, capture and replays, two segments chained through an
  eager autograd.Function; an input at a new address copied into the
  captured buffer, one at that address not; the sync
  guard, and no collective, inside every captured segment of a frames
  rank's step (rank 0 of two, its partner's collectives answered in
  this process);
* the program a solver keeps across its fits, on the stand-in route:
  a second fit of another clip captures nothing and gives a new
  solver's bits, leaving the state the first fit returned as it was; a
  fit at another length captures anew and gives a new solver's bits; the
  section marks, the route, the config and the scene tensor each key a
  new program;
* on the card (`gpu`), the graph route against the eager one; fits of
  clips A, B, A on one solver, each bit-equal to a new solver's, the
  last two capturing nothing and holding no more memory; and a segment
  chained with an eager op, graph against eager.

The module imports no JAX: the card's machine runs its `gpu` test with
``--noconftest``, and the tests that hold the port to JAX import it
inside (skipping where it is missing, which it is not here).
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from fpv4d_torch.parallel import sharding as SH
from fpv4d_torch.parallel.multi_clip import MultiClipSolver
from fpv4d_torch.solve import step_graph
from fpv4d_torch.solve.adam import Adam
from fpv4d_torch.solve.clip_solve import ClipSolver
from fpv4d_torch.utils import checkpoint as CK
from fpv4d_torch.utils import observability as OBS
from fpv4d_torch.utils.bench_problem import fleet_batch, standard_problem

# ClipState's leaf shapes at T = 12, one DCT window
SHAPES = [(12, 78), (), (12, 4, 4), (1, 23, 3, 5)]


# -- the Adam -----------------------------------------------------------------

@pytest.mark.parametrize("lr", [0.005, 0.1])
def test_adam_matches_optax(lr):
    """20 steps from the same leaves and gradients, one leaf's gradient
    zero (a masked leaf) in every other step."""
    jnp = pytest.importorskip("jax.numpy")
    optax = pytest.importorskip("optax")
    rng = np.random.RandomState(0)
    leaves = [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]
    grads = [[np.asarray(rng.randn(*s) * 10.0 ** rng.uniform(-3, 1),
                         np.float32) for s in SHAPES] for _ in range(20)]
    for k in range(0, 20, 2):
        grads[k][3] = np.zeros_like(grads[k][3])
    ref = optax.adam(lr)
    jp = [jnp.asarray(x) for x in leaves]
    js = ref.init(jp)
    tp = [torch.tensor(x) for x in leaves]
    opt = Adam(tp, lr)
    for g in grads:
        upd, js = ref.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for p, x in zip(tp, g):
            p.grad += torch.from_numpy(x)
        opt.step()
    assert int(opt.count) == int(js[0].count) == 20
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-12)
    for mine, theirs in ((opt.mu, js[0].mu), (opt.nu, js[0].nu)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-30)


def test_adam_select_steps_rows_in_place():
    """select(sl) steps the rows of the leaves and moments in place from
    a copy of the count: rows stepped that way equal the whole Adam's."""
    rng = np.random.RandomState(1)
    shapes = [(4, 12, 78), (4,), (4, 12, 4, 4)]
    init = [torch.tensor(np.asarray(rng.randn(*s), np.float32))
            for s in shapes]
    grads = [torch.tensor(np.asarray(rng.randn(*s), np.float32))
             for s in shapes]
    whole = Adam([x.clone() for x in init], 0.01)
    parts = Adam([x.clone() for x in init], 0.01)
    for _ in range(3):
        for p, g in zip(whole.params, grads):
            p.grad.copy_(g)
        whole.step()
    for sl in (slice(0, 2), slice(2, 4)):
        sub = parts.select(sl)
        for _ in range(3):
            for q, g in zip(sub.params, grads):
                q.grad.copy_(g[sl])
            sub.step()
    parts.count.copy_(sub.count)
    assert int(parts.count) == 3
    for a, b in zip(parts.params + parts.mu + parts.nu,
                    whole.params + whole.mu + whole.nu):
        assert torch.equal(a, b)


# -- stand-ins for a capture ----------------------------------------------------

_SYNCS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
          "aten.is_nonzero", "aten.lift_fresh", "aten._unique2"}


class NoSync(TorchDispatchMode):
    """Raises on an op that reads a value back to the host or makes a
    tensor of host data (a capture cannot), on a collective (gloo stages
    its tensors through the host), and on boolean-mask indexing (a
    data-dependent shape)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket._qualified_op_name.replace("::", ".")
        if name in _SYNCS or name.startswith(("c10d.",
                                              "_c10d_functional.")):
            raise AssertionError(f"{name} in a captured step")
        if name in ("aten.index", "aten.index_put", "aten.index_put_"):
            idx = args[1] if len(args) > 1 else []
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in idx):
                raise AssertionError(f"boolean-mask {name} in a captured "
                                     "step")
        return func(*args, **(kwargs or {}))


class GuardedCapture:
    """Runs the step once under NoSync where a capture would record it
    (``active`` meanwhile); a replay does nothing."""
    captured = []
    active = False

    def __init__(self, step, pool, stream):
        GuardedCapture.active = True
        try:
            with NoSync():
                self.out = step()
        finally:
            GuardedCapture.active = False
        GuardedCapture.captured.append(self)

    def replay(self):
        pass


class RerunCapture:
    """Records the step as a capture does (nothing runs); each replay
    reruns it, its loss the output a graph's replay rewrites."""

    def __init__(self, step, pool, stream):
        self.step = step
        self.out = None

    def replay(self):
        self.out = self.step()


def _programmed(solver, make_graph):
    """solver.program() returns a graph-route program on the CPU with
    `make_graph` for the capture; returns the programs it made."""
    made = []

    def program():
        made.append(step_graph.PhaseProgram("cpu", True, make_graph))
        return made[-1]

    solver.program = program
    return made


def _small(nn_impl="grid", T=12, **cfg):
    prob = standard_problem(T=T, num_verts=256, scene_pts=400, num_iter=20,
                            num_iter_dct=160, skate_subset=64,
                            contact_compact=32, nn_impl=nn_impl,
                            device="cpu")
    prob.solver.config = dataclasses.replace(
        prob.solver.config, **dict(dict(window=T), **cfg))
    return prob


# every phase of each case, each captured once on the graph route, with
# the contact refresh of a phase on lazy tables and the planted-foot
# detection ahead of the skate phase
_GUARD_CASES = {
    "local, lazy tables": (dict(), "local", {
        ("local_a", True, False), ("local_a", True, False, "cands"),
        ("local_b", False, False), ("detect_contact",),
        ("skate", False, False)}),
    "local, exact grid": (dict(contact_refresh_steps=0), "local", {
        ("local_a", False, False), ("local_b", False, False),
        ("detect_contact",), ("skate", False, False)}),
    "global, brute force": (dict(nn_impl="brute"), "global", {
        ("global_a", False, False), ("global_b", False, False)}),
    "dct, lazy tables": (dict(), "dct", {
        ("dct_a", False, False), ("dct_b", True, False),
        ("dct_b", True, False, "cands")}),
}


@pytest.mark.parametrize("case", sorted(_GUARD_CASES))
def test_captured_steps_never_sync(case):
    kw, mode, keys = _GUARD_CASES[case]
    prob = _small(**kw)
    made = _programmed(prob.solver, GuardedCapture)
    GuardedCapture.captured = []
    _, hist = prob.solver.fit(prob.body, prob.cam, mode=mode)
    assert set(made[0].capture_seconds) == keys
    assert len(GuardedCapture.captured) == len(keys)
    assert all(np.all(np.isfinite(v)) for v in hist.values())


def test_fleet_chunked_skate_steps_never_sync():
    """The fleet on one rank: each chunk of 2 of 4 clips captured once."""
    prob = _small()
    made = _programmed(prob.solver, GuardedCapture)
    bodies, cams, scenes = fleet_batch(prob, 4)
    MultiClipSolver(solver=prob.solver).fit(bodies, cams, scenes,
                                            mode="local")
    keys = set(made[0].capture_seconds)
    assert {k for k in keys if k[0] == "skate"} == {
        ("skate", False, False, 0), ("skate", False, False, 2)}
    assert {k[0] for k in keys} == {"local_a", "local_b", "skate",
                                    "detect"}


def _equal_runs(a, b):
    (sa, ha), (sb, hb) = a, b
    assert ha.keys() == hb.keys()
    for k in ha:
        assert np.array_equal(ha[k], hb[k]), k
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode,nn_impl,sdf", [
    ("local", "grid", False), ("global", "brute", False),
    ("dct", "grid", False), ("global", "grid", True)])
def test_graph_route_plumbing_matches_eager(mode, nn_impl, sdf):
    """Warm-up, capture, replays and the staged tables (and SDF
    linearizations) of each chunk, with replays that rerun the captured
    step: the same bits as the eager route."""
    from fpv4d_torch.ops import sdf as SDF
    prob = _small(nn_impl=nn_impl, contact_refresh_steps=3)
    if sdf:
        prob.solver.sdf = SDF.plane_sdf(y0=-0.95, extent=4.0, dim=17)
    eager = prob.solver.fit(prob.body, prob.cam, mode=mode)
    made = _programmed(prob.solver, RerunCapture)
    graphed = prob.solver.fit(prob.body, prob.cam, mode=mode)
    assert made[0].capture_seconds                    # it captured
    assert made[0]._steps                             # kept after the fit
    prob.solver.close()
    assert not (made[0]._steps or made[0]._static)    # dropped by close
    _equal_runs(graphed, eager)


def test_fleet_graph_route_plumbing_matches_eager():
    prob = _small(contact_refresh_steps=1)
    bodies, cams, scenes = fleet_batch(prob, 4)
    mc = MultiClipSolver(solver=prob.solver)
    eager = mc.fit(bodies, cams, scenes, mode="local")
    _programmed(prob.solver, RerunCapture)
    _equal_runs(mc.fit(bodies, cams, scenes, mode="local"), eager)


# -- the program a solver keeps across its fits -----------------------------------

def _clips(prob):
    """Clips A and B of the problem's length (B the body moved by noise)
    and a clip of twice the length (B, then A)."""
    bodies, cams, _ = fleet_batch(prob, 2)
    return ((bodies[0], cams[0]), (bodies[1], cams[1]),
            (np.concatenate([bodies[1], bodies[0]]),
             np.concatenate([cams[1], cams[0]])))


def _fresh_fit(kw, mode, clip):
    """A new solver's fit of `clip` on the stand-in graph route."""
    prob = _small(**kw)
    _programmed(prob.solver, RerunCapture)
    return prob.solver.fit(*clip, mode=mode)


@pytest.mark.parametrize("case", sorted(_GUARD_CASES))
def test_kept_program_serves_the_next_fit(case):
    """Two fits of different clips on one solver: the second captures
    nothing (``captures`` 0, ``capture_seconds`` empty) and gives a new
    solver's bits for its clip; the state the first fit returned is
    unchanged by it."""
    kw, mode, keys = _GUARD_CASES[case]
    prob = _small(**kw)
    made = _programmed(prob.solver, RerunCapture)
    a, b, _ = _clips(prob)
    with OBS.tracing():
        first, _ = prob.solver.fit(*a, mode=mode)
        assert prob.solver.trace_counts["captures"] == len(keys)
        before = [x.clone() for x in first]
        second = prob.solver.fit(*b, mode=mode)
        assert prob.solver.trace_counts["captures"] == 0
    assert len(made) == 1 and prob.solver.capture_seconds == {}
    for x, y in zip(first, before):
        assert torch.equal(x, y)
    _equal_runs(second, _fresh_fit(kw, mode, b))


@pytest.mark.parametrize("case", sorted(_GUARD_CASES))
def test_kept_program_gives_way_to_another_length(case):
    """A fit at twice the length on the same solver closes the kept
    program, captures anew and gives a new solver's bits."""
    kw, mode, keys = _GUARD_CASES[case]
    prob = _small(**kw)
    made = _programmed(prob.solver, RerunCapture)
    a, _, long = _clips(prob)
    prob.solver.fit(*a, mode=mode)
    got = prob.solver.fit(*long, mode=mode)
    assert len(made) == 2 and not made[0]._steps
    assert set(made[1].capture_seconds) == keys
    _equal_runs(got, _fresh_fit(kw, mode, long))


def test_kept_program_keyed_on_its_signature():
    """A fit with the section marks on, on the other route, with another
    config or with another scene tensor makes a new program; a fit with
    none of these changed keeps the last one."""
    prob = _small(nn_impl="brute")
    s = prob.solver
    made = _programmed(s, RerunCapture)

    def fit():
        s.fit(prob.body, prob.cam, mode="global")
        return len(made)

    assert fit() == 1 and fit() == 1
    with OBS.tracing(sections=True):
        assert fit() == 2
    assert fit() == 3
    s.step_graphs = True
    assert fit() == 4
    s.config = dataclasses.replace(s.config, lr=s.config.lr / 2)
    assert fit() == 5
    s.scene = s.scene.clone()
    assert fit() == 6 and fit() == 6
    assert not any(p._steps for p in made[:-1])


# -- parity with the JAX package ------------------------------------------------

_PARITY = {("local", "grid"): {"local_a": 1e-4, "local_b": 1e-4,
                               "local_skate": 1e-3},
           ("global", "brute"): {"global_a": 1e-4, "global_b": 1e-4}}


@pytest.fixture(scope="module")
def reference():
    """tests/test_torch_clip_solve.py (the JAX package's solver beside the
    port's) and its scenario."""
    tc = pytest.importorskip("test_torch_clip_solve",
                             reason="needs the JAX package")
    return tc, tc.make_scenario()


@pytest.mark.parametrize("mode,nn_impl", sorted(_PARITY))
def test_eager_program_matches_reference(reference, mode, nn_impl):
    tc, sc = reference
    js, ts = tc._solvers(sc, nn_impl=nn_impl, contact_compact=64)
    assert ts.step_graphs is False and ts.program().graphs is False
    jstate, jh, tstate, th = tc._fit_both(sc, js, ts, mode)
    for k, rtol in _PARITY[mode, nn_impl].items():
        np.testing.assert_allclose(th[k], jh[k], rtol=rtol, err_msg=k)
    tc._check_final(jstate, tstate)


# -- checkpoint -----------------------------------------------------------------

def test_checkpoint_resumes_the_solve(tmp_path):
    """local_a.pt of a local fit, loaded into a fresh Adam over the
    loaded leaves, runs local_b, detection and skate to the fit's own
    histories and final state."""
    prob = _small(contact_refresh_steps=4)
    s = prob.solver
    final, hist = s.fit(prob.body, prob.cam, mode="local",
                        checkpoint_dir=str(tmp_path))
    leaves, opt_state, step = CK.load_solver_state(
        str(tmp_path / "local_a.pt"))
    assert step == len(hist["local_a"])
    st0, target, weights = s.init_state(prob.body, prob.cam)
    state, opt = s.make_optimizer(type(st0)(**leaves))
    opt.load_state_dict(opt_state)
    assert int(opt.count) == step
    cfg = s.config
    h_b = s._run_phase_auto(state, opt, target, weights,
                            cfg.num_iter - len(hist["local_a"]), "local_b")
    wr = s.detect_contact(state)
    h_s = s._run_skate_phase(state, opt, target, weights,
                             len(hist["local_skate"]), wr)
    assert np.array_equal(h_b.numpy(), hist["local_b"])
    assert np.array_equal(h_s.numpy(), hist["local_skate"])
    for x, y in zip(state, final):
        assert torch.equal(x.detach(), y)
    assert int(opt.count) == sum(len(v) for v in hist.values())


# -- launch accounting and the route's switches -----------------------------------

class CountingCapture:
    """A capture that runs the step (whose stand-in kernels count) and
    replays nothing."""

    def __init__(self, step, pool, stream):
        self.out = step()

    def replay(self):
        pass


def _stand_in_kernels(*_):
    """One call's stand-in kernels: K1's route counted once, K2's
    twice."""
    OBS.count("k1/cuda")
    OBS.count("k2/cuda", 2)
    return torch.zeros(())


class _CountedBackward(torch.autograd.Function):
    """A stand-in kernel whose backward launches twice (K2's count)."""

    @staticmethod
    def forward(ctx, x):
        return x * 3.0

    @staticmethod
    def backward(ctx, g):
        OBS.count("k2/cuda", 2)
        return g * 3.0


def _k12() -> tuple:
    got = OBS.counts()
    return got.get("k1/cuda", 0), got.get("k2/cuda", 0)


@pytest.mark.parametrize("route", ["call", "segment", "refresh"])
def test_launch_accounting(route):
    """The route counters through a program, under tracing: warm-up
    calls count as the kernels count them, a capture counts nothing, and
    each replay adds what one captured call counted (a segment's forward
    and backward graphs each theirs). A call goes through ``run``, whose
    later runs of a key replay from their first step; a refresh's first
    call runs it eagerly once (its result dropped), then replays its
    capture."""
    prog = step_graph.PhaseProgram("cpu", True, CountingCapture)
    x = torch.ones(3, requires_grad=True)

    def fn(x):
        OBS.count("k1/cuda")
        return _CountedBackward.apply(x).sum()

    once = {"call": lambda: prog.run(("a",), _stand_in_kernels, 1),
            "segment": lambda: prog.segment(("a",), fn, x).backward(),
            "refresh": lambda: prog.refresh(
                ("a",), lambda _: (_stand_in_kernels(),))}[route]
    extra = int(route == "refresh")
    OBS.reset_counts()
    with OBS.tracing():
        for n in range(1, 8):
            once()
            assert _k12() == (n + extra, 2 * (n + extra))
        if route == "segment":
            # a call whose output is not differentiated replays no backward
            with torch.no_grad():
                prog.segment(("a",), fn, x)
            assert _k12() == (8, 14)
        if route == "call":
            prog.run(("a",), _stand_in_kernels, 5)
            assert _k12() == (12, 24)
            assert OBS.counts()["replays/a"] == 12 - step_graph.WARMUP_STEPS
    OBS.reset_counts()
    assert set(prog.capture_seconds) == (
        {("a", "forward"), ("a", "backward")} if route == "segment"
        else {("a",)})


def test_capture_untraced_adds_nothing_on_replays():
    """A capture made with tracing off keeps what its step counted apart
    as one made with tracing on does, and adds nothing to the counters;
    its replays add nothing while tracing is off, and with tracing on
    each adds the route counts (a graph kept across a solver's fits is
    captured untraced and replayed in a traced fit) besides
    ``replays/<phase>``."""
    prog = step_graph.PhaseProgram("cpu", True, CountingCapture)
    OBS.reset_counts()
    prog.run(("a",), _stand_in_kernels, step_graph.WARMUP_STEPS + 3)
    assert prog._steps[("a",)][1] == {"k1/cuda": 1, "k2/cuda": 2}
    assert OBS.counts() == {}
    with OBS.tracing():
        prog.run(("a",), _stand_in_kernels, 5)
        counts = OBS.counts()
    OBS.reset_counts()
    assert counts == {"replays/a": 5, "k1/cuda": 5, "k2/cuda": 10}
    assert prog.run(("c",), _stand_in_kernels, 0).shape == (0,)


def test_routes_on_the_cpu():
    prob = _small()
    m = prob.model
    kw = dict(vposer_params=prob.vp, scene_verts=prob.scene,
              contact_vids=prob.solver.contact_vids,
              contact_vids_left=prob.solver.contact_vids_left,
              contact_vids_right=prob.solver.contact_vids_right,
              device="cpu")
    assert ClipSolver(m, **kw).step_graphs is False
    assert ClipSolver(m, step_graphs=False, **kw).step_graphs is False
    with pytest.raises(ValueError, match="step_graphs"):
        ClipSolver(m, step_graphs=True, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        step_graph.PhaseProgram("cpu", True)


# -- the segment ------------------------------------------------------------------

class _Swap(torch.autograd.Function):
    """An eager op between two segments, as a collective's function is:
    its rows reversed, the gradient reversed back and doubled."""

    @staticmethod
    def forward(ctx, x):
        return x.flip(0)

    @staticmethod
    def backward(ctx, g):
        return g.flip(0) * 2.0


def _first(x, w):
    h = torch.tanh(x @ w)
    return h.sum(1), h


def _second(h, w, part):
    return (h * w[:, :1].T).square().sum(1) + part


def _chain(prog, x, w):
    """segment -> eager op -> segment, or the plain functions without a
    program; a step's loss [B]."""
    if prog is None:
        part, h = _first(x, w)
        return _second(_Swap.apply(h), w, part)
    part, h = prog.segment(("k", "first"), _first, x, w)
    return prog.segment(("k", "second"), _second, _Swap.apply(h), w, part)


def _steps(prog, n=6, seed=0):
    """n steps, each on a new x (a new address, as a collective's output
    is) and the same leaf w: the losses and gradients of every step."""
    rng = np.random.RandomState(seed)
    w = torch.tensor(rng.randn(4, 4).astype(np.float32), requires_grad=True)
    out = []
    for _ in range(n):
        x = torch.tensor(rng.randn(5, 4).astype(np.float32),
                         requires_grad=True)
        loss = _chain(prog, x * 1.0, w)
        w.grad = None
        loss.sum().backward()
        out.append((loss.detach().clone(), x.grad.clone(), w.grad.clone()))
        with torch.no_grad():
            w -= 0.1 * w.grad
    return out


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_segment_matches_plain_autograd(route):
    """Over 2 warm-up calls, the capture and 3 replays (a stand-in whose
    replay reruns the captured function): the same bits as the plain
    functions under autograd."""
    prog = (step_graph.eager("cpu") if route == "eager"
            else step_graph.PhaseProgram("cpu", True, RerunCapture))
    want = _steps(None)
    got = _steps(prog)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    if route == "graph":
        assert set(prog.capture_seconds) == {
            ("k", n, d) for n in ("first", "second")
            for d in ("forward", "backward")}


class _Ops(TorchDispatchMode):
    """Records the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_segment_copies_only_inputs_at_a_new_address(monkeypatch):
    monkeypatch.setattr(step_graph, "WARMUP_STEPS", 0)
    prog = step_graph.PhaseProgram("cpu", True, CountingCapture)
    fixed = torch.ones(3)
    prog.segment(("s",), lambda a, b: a + b, fixed, torch.zeros(3))
    held = prog._segments[("s",)].ins
    assert held[0].data_ptr() == fixed.data_ptr()
    rec = _Ops()
    with rec:
        prog.segment(("s",), lambda a, b: a + b, fixed, held[1])
    assert "copy_" not in rec.ops
    new = torch.full((3,), 7.0)
    rec = _Ops()
    with rec:
        prog.segment(("s",), lambda a, b: a + b, fixed, new)
    assert rec.ops.count("copy_") == 1
    assert held[1].data_ptr() != new.data_ptr()
    assert torch.equal(held[1], new)
    with pytest.raises(ValueError, match="shape"):
        prog.segment(("s",), lambda a, b: a + b, fixed, torch.zeros(4))


def _local_collectives(monkeypatch):
    """torch.distributed's all_gather and all_reduce answered in this
    process for rank 0 of two frames ranks whose partner holds the same
    values; each raises inside a captured step or segment."""
    def all_gather(parts, x, group=None):
        assert not GuardedCapture.active, "a collective inside a capture"
        for p in parts:
            p.copy_(x)

    def all_reduce(x, group=None):
        assert not GuardedCapture.active, "a collective inside a capture"
        x.mul_(2.0)

    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)


_FRAMES_GUARD = {
    "local, lazy tables": (dict(), "local", {
        "local_a": ("own", "adam", "cands"), "local_b": ("own", "adam"),
        "skate": ("own", "adam")}),
    "global, brute force": (dict(nn_impl="brute"), "global", {
        "global_a": ("own", "adam"), "global_b": ("own", "adam")}),
    "dct, joints gathered": (dict(), "dct", {
        "dct_a": ("own", "adam"), "dct_b": ("own", "dct", "adam",
                                             "cands")}),
}


@pytest.mark.parametrize("case", sorted(_FRAMES_GUARD))
def test_frames_rank_segments_never_sync(monkeypatch, case):
    """A frames rank's whole fit (rank 0 of {clips: 1, frames: 2}) on
    the graph route: the halo, the gathered joints and the gradient sum
    run between the captures, every segment's forward and backward, the
    Adam step and the refresh run under the sync guard, and every phase
    captures the pieces its step is cut into."""
    kw, mode, pieces = _FRAMES_GUARD[case]
    _local_collectives(monkeypatch)
    prob = _small(**kw)
    made = _programmed(prob.solver, GuardedCapture)
    GuardedCapture.captured = []
    mesh = SH.Mesh({"clips": 1, "frames": 2}, 0, {"frames": None})
    bodies, cams, scenes = fleet_batch(prob, 1)
    _, hist = MultiClipSolver(solver=prob.solver, mesh=mesh).fit(
        bodies, cams, scenes, mode=mode)
    keys = set(made[0].capture_seconds)
    for phase, names in pieces.items():
        mine = {k[3:] for k in keys if k[0] == phase}
        want = {(n, d) for n in names if n not in ("adam", "cands")
                for d in ("forward", "backward")}
        want |= {(n,) for n in names if n in ("adam", "cands")}
        assert mine == want, phase
    assert len(GuardedCapture.captured) == len(keys)
    assert all(np.all(np.isfinite(v)) for v in hist.values())


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode,nn_impl", [("local", "grid"),
                                          ("global", "brute"),
                                          ("dct", "grid")])
def test_graph_route_matches_eager_on_the_card(cuda_device, mode, nn_impl):
    """T = 12: the graph route's histories within chip_smoke.py's
    _hold_histories limits of the eager route's (first loss 1e-5, later
    2e-2), the same K1 and K2 launches."""
    prob = standard_problem(T=12, num_verts=512, scene_pts=2500,
                            num_iter=60, num_iter_dct=200, skate_subset=64,
                            contact_compact=64, nn_impl=nn_impl,
                            device=cuda_device)
    s = prob.solver
    runs = {}
    for graphs in (False, True):
        s.step_graphs = graphs
        with OBS.tracing():
            _, hist = s.fit(prob.body, prob.cam, mode=mode)
        torch.cuda.synchronize()
        got = s.trace_counts
        runs[graphs] = (hist, got.get("k1/cuda", 0), got.get("k2/cuda", 0))
    (he, k1e, k2e), (hg, k1g, k2g) = runs[False], runs[True]
    assert (k1g, k2g) == (k1e, k2e) and k1e + k2e > 0
    assert set(s.capture_seconds) == set(hg) | (
        {"detect_contact"} if mode == "local" else set())
    first = next(iter(he))
    assert abs(hg[first][0] - he[first][0]) <= 1e-5 * abs(he[first][0])
    for k in he:
        rel = np.abs(hg[k] - he[k]) / np.abs(he[k])
        assert np.all(np.isfinite(hg[k])) and rel.max() < 2e-2, k


@pytest.mark.gpu
@pytest.mark.parametrize("mode,nn_impl", [("local", "grid"),
                                          ("global", "brute"),
                                          ("dct", "grid")])
def test_kept_program_on_the_card(cuda_device, mode, nn_impl):
    """T = 12: fits of clips A, B, A on one solver, each history
    bit-equal to a new solver's fit of its clip; fits 2 and 3 capture
    nothing, and the memory allocated after fit 3 is what it was after
    fit 2."""
    def problem():
        return standard_problem(T=12, num_verts=512, scene_pts=2500,
                                num_iter=60, num_iter_dct=200,
                                skate_subset=64, contact_compact=64,
                                nn_impl=nn_impl, device=cuda_device)

    prob = problem()
    bodies, cams, _ = fleet_batch(prob, 2)
    fresh = [problem().solver.fit(bodies[i], cams[i], mode=mode)[1]
             for i in (0, 1)]
    gc.collect()
    s = prob.solver
    allocated = []
    for n, i in enumerate((0, 1, 0)):
        with OBS.tracing():
            _, hist = s.fit(bodies[i], cams[i], mode=mode)
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(cuda_device))
        assert hist.keys() == fresh[i].keys()
        for k in hist:
            assert np.array_equal(hist[k], fresh[i][k]), (n, k)
        assert (s.trace_counts["captures"] > 0) == (n == 0), n
        assert bool(s.capture_seconds) == (n == 0), n
    assert allocated[2] == allocated[1], allocated


@pytest.mark.gpu
def test_segment_graph_matches_eager_on_the_card(cuda_device):
    """Two segments chained through an eager op (cuBLAS in both), 6 steps
    on a new input each: the captured forward and backward graphs give
    the eager route's bits."""
    def run(graphs):
        prog = step_graph.PhaseProgram(cuda_device, graphs)
        rng = np.random.RandomState(0)
        w = torch.tensor(rng.randn(64, 64).astype(np.float32),
                         device=cuda_device, requires_grad=True)
        out = []
        for _ in range(6):
            x = torch.tensor(rng.randn(256, 64).astype(np.float32),
                             device=cuda_device, requires_grad=True)
            loss = _chain(prog, x * 1.0, w)
            w.grad = None
            loss.sum().backward()
            out.append([t.detach().clone() for t in (loss, x.grad, w.grad)])
            with torch.no_grad():
                w -= 0.01 * w.grad
        torch.cuda.synchronize()
        return out, dict(prog.capture_seconds)

    (eager, none), (graph, caps) = run(False), run(True)
    assert not none and len(caps) == 4
    for a, b in zip(graph, eager):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
