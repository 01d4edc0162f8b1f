"""L-BFGS as optax 0.2.6 computes it, batched over independent problems.

The keypoint fit runs two L-BFGS variants of optax (``optax.lbfgs``):
  * ``linesearch="zoom"``: ``optax.lbfgs(memory_size=m)`` with its
    defaults: a scaled-identity initial preconditioner (the first step
    capped to a unit ball), the direction scaled by -1, and the zoom
    line search (Nocedal & Wright 3.5/3.6 with Hager-Zhang's approximate
    decrease test; at most 20 evaluations, first guess 1);
  * ``linesearch="backtracking"``: the same direction with
    ``scale_by_backtracking_linesearch(max_backtracking_steps=15,
    store_grad=True)`` and its defaults (slope_rtol 1e-4, decrease 0.8,
    increase 1.5, max_learning_rate 1.0).
Both reuse the value and gradient that the line search stored
(``optax.value_and_grad_from_state``). ``torch.optim.LBFGS`` is another
algorithm: it scales its first step, searches and updates its memory
differently.

Problems are the rows ("lanes") of x [B, D]. Each lane has its own
memory, line search and step size, as ``jax.vmap`` of the optax loop
gives them: a lane whose search has ended keeps its state while the
others go on, and the loop runs until every lane has ended. The
objective maps x [B, D] to values [B], lane by lane.

Device form, the counterpart of the reference's one jitted ``lax.scan``
of optax's L-BFGS per stage with its line searches as ``lax.while_loop``
s (fpv4d/solve/keypoint_fit.py:343-414): everything an iteration carries
(x, the memory ring and the previous params and gradient, the value,
gradient and step size, the line search's state) lives at one address
for the whole stage and is updated in place; the iteration count is an
int32 device tensor, its first-step case a ``torch.where`` on it and the
ring's order device indices. An iteration is five pieces, each a
function of those buffers run through a phase program
(``solve/step_graph.PhaseProgram.call``; captured once each on the
card): ``start`` (whether a lane holds no finite value), ``reeval``
(those lanes' value and gradient), ``begin`` (the direction and the line
search's first state, every lane searching), ``round`` (one line-search
evaluation, masked to the lanes still searching; whether any still
searches) and ``finish`` (the step). A line search's end and the
re-evaluation are read through ``PhaseProgram.gate``: a host read of a
one-element device flag between replays (the torch this targets has no
conditional graph nodes), or, on a stand-in capture, every round up to
the search's cap. Every update of a round is masked by the lanes still
searching, so a round run after every lane has ended changes nothing.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from fpv4d_torch.solve import step_graph

Objective = Callable[[torch.Tensor], torch.Tensor]

ZOOM_MAX_STEPS = 20
BACKTRACK_MAX_STEPS = 15


def value_and_grad(fn: Objective, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane values [B] and gradients [B, D] (lanes are independent,
    so the gradient of the sum is each lane's own)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        v = fn(x)
        g, = torch.autograd.grad(v.sum(), x)
    return v.detach(), g


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _col(s: torch.Tensor) -> torch.Tensor:
    return s[:, None]


def _nan_to_inf(e: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)


def _put(dst: torch.Tensor, sel: torch.Tensor, val: torch.Tensor) -> None:
    """dst[lane] = val[lane] where sel[lane], in place."""
    torch.where(sel if sel.dim() == dst.dim() else _col(sel), val, dst,
                out=dst)


# -- the L-BFGS direction (optax.scale_by_lbfgs) -------------------------------

class _Memory:
    """scale_by_lbfgs's state: the previous params and gradient and the
    last m differences, a ring indexed by the step count (an int32
    device tensor)."""

    def __init__(self, x: torch.Tensor, m: int):
        self.m = m
        self.count = torch.zeros((), dtype=torch.int32, device=x.device)
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dw = torch.zeros((m,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros((m, x.shape[0]), dtype=x.dtype,
                               device=x.device)
        self._ring = torch.arange(m, device=x.device)

    def direction(self, x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """Store (x - x_prev, g - g_prev), then return P g."""
        m, k = self.m, self.count.long()
        first = k == 0
        prev = torch.remainder(k - 1, m).reshape(1)
        dw, du = x - self.params, grad - self.updates
        vd = _vdot(du, dw)
        w = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        dw = torch.where(first, torch.zeros_like(dw), dw)
        du = torch.where(first, torch.zeros_like(du), du)
        w = torch.where(first, torch.zeros_like(w), w)
        self.dw.index_copy_(0, prev, dw[None])
        self.du.index_copy_(0, prev, du[None])
        self.rho.index_copy_(0, prev, w[None])
        den = _vdot(du, du)
        scale = torch.where(den > 0.0, _vdot(du, dw) / den,
                            torch.ones_like(den))
        # first step: a capped reciprocal of the gradient norm
        scale = torch.where(first, torch.clamp(
            1.0 / torch.linalg.vector_norm(grad, dim=-1), max=1.0), scale)
        # the ring from the oldest entry (index k % m) to the newest
        order = torch.remainder(k + self._ring, m)
        rho, dws, dus = (t.index_select(0, order)
                         for t in (self.rho, self.dw, self.du))
        vec, alphas = grad, [None] * m
        for j in reversed(range(m)):
            alphas[j] = rho[j] * _vdot(dws[j], vec)
            vec = vec + _col(-alphas[j]) * dus[j]
        vec = _col(scale) * vec
        for j in range(m):
            beta = rho[j] * _vdot(dus[j], vec)
            vec = vec + _col(alphas[j] - beta) * dws[j]
        self.params.copy_(x)
        self.updates.copy_(grad)
        self.count.add_(1)
        return vec


# -- optax.scale_by_backtracking_linesearch (store_grad=True) ------------------

class _Backtracking:
    """Armijo backtracking per lane: the learning rate, the value and
    the gradient at the last point each lane evaluated."""

    def __init__(self, st: "_Lbfgs", max_steps: int = BACKTRACK_MAX_STEPS,
                 slope_rtol: float = 1e-4, decrease: float = 0.8,
                 increase: float = 1.5, max_lr: float = 1.0):
        self.st, self.max_steps = st, max_steps
        self.slope_rtol, self.decrease = slope_rtol, decrease
        self.increase, self.max_lr = increase, max_lr
        v = st.value
        self.cap = max_steps + 1
        self.slope = torch.zeros_like(v)
        self.lr = torch.zeros_like(v)
        self.new_value = torch.zeros_like(v)
        self.err = torch.zeros_like(v)
        self.it = torch.zeros_like(v, dtype=torch.int64)

    def _active(self) -> torch.Tensor:
        return ~(self.err <= 0.0) & (self.it <= self.max_steps)

    def begin(self) -> None:
        st = self.st
        self.slope.copy_(_vdot(st.u, st.grad))
        self.lr.copy_(torch.clamp(self.increase * st.lr, max=self.max_lr))
        self.new_value.copy_(st.value)
        self.err.fill_(float("inf"))
        self.it.zero_()

    def round(self) -> torch.Tensor:
        st = self.st
        active = self._active()
        lr_t = torch.where(self.it > 0, self.decrease * self.lr, self.lr)
        v = st.fn(st.x + _col(lr_t) * st.u).detach()
        e = torch.clamp(_nan_to_inf(v - st.value - lr_t * self.slope_rtol
                                    * self.slope), min=0.0)
        _put(self.lr, active, lr_t)
        _put(self.new_value, active, v)
        _put(self.err, active, e)
        self.it.add_(active.to(self.it.dtype))
        return self._active().any()

    def finish(self) -> None:
        # every lane's gradient is taken at the last point it evaluated
        # (its search ends there, accepted or at the step limit)
        st = self.st
        _, new_grad = value_and_grad(st.fn, st.x + _col(self.lr) * st.u)
        st.lr.copy_(torch.where(torch.isinf(self.err),
                                torch.zeros_like(self.lr), self.lr))
        st.value.copy_(self.new_value)
        st.grad.copy_(new_grad)


# -- optax.scale_by_zoom_linesearch ---------------------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r1 + (-(db ** 2)) * r2) / denom
    B = ((-(dc ** 3)) * r1 + db ** 3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


# the zoom state's fields (``grad`` and ``g_safe`` are [B, D], the rest [B])
_ZOOM_FLOAT = ("stepsize", "value", "slope", "dec", "curv", "low", "v_low",
               "s_low", "high", "v_high", "s_high", "cref", "v_cref", "safe",
               "v_safe")
_ZOOM_BOOL = ("found", "done", "failed")


class _Zoom:
    """The zoom line search per lane, first guess 1 and no largest step:
    the step size, the value and the gradient there."""

    def __init__(self, st: "_Lbfgs", max_steps: int = ZOOM_MAX_STEPS,
                 slope_rtol: float = 1e-4, curv_rtol: float = 0.9,
                 approx_dec_rtol: float = 1e-6, increase: float = 2.0,
                 interval_threshold: float = 1e-5):
        self.st, self.max_steps, self.cap = st, max_steps, max_steps
        self.slope_rtol, self.curv_rtol = slope_rtol, curv_rtol
        self.approx_dec_rtol, self.increase = approx_dec_rtol, increase
        self.interval_threshold = interval_threshold
        v = st.value
        self.slope0 = torch.zeros_like(v)
        s = {k: torch.zeros_like(v) for k in _ZOOM_FLOAT}
        s.update({k: torch.zeros_like(v, dtype=torch.bool)
                  for k in _ZOOM_BOOL})
        s["count"] = torch.zeros_like(v, dtype=torch.int64)
        s["grad"] = torch.zeros_like(st.grad)
        s["g_safe"] = torch.zeros_like(st.grad)
        self.s = s

    def _active(self) -> torch.Tensor:
        return ~(self.s["done"] | self.s["failed"])

    def begin(self) -> None:
        st, s = self.st, self.s
        self.slope0.copy_(_vdot(st.u, st.grad))
        for k in ("count", "stepsize", "dec", "curv", "low", "high", "cref",
                  "safe") + _ZOOM_BOOL:
            s[k].zero_()
        s["dec"].fill_(float("inf"))
        s["curv"].fill_(float("inf"))
        for k in ("value", "v_low", "v_high", "v_cref", "v_safe"):
            s[k].copy_(st.value)
        for k in ("slope", "s_low", "s_high"):
            s[k].copy_(self.slope0)
        s["grad"].copy_(st.grad)
        s["g_safe"].copy_(st.grad)

    def round(self) -> torch.Tensor:
        st, s = self.st, self.s
        value, slope0 = st.value, self.slope0
        slope_rtol, increase = self.slope_rtol, self.increase
        z = torch.zeros_like(value)
        active = self._active()
        found, count = s["found"], s["count"]
        # the point to evaluate: the interval search's next step, or the
        # zoom's interpolated middle, lane by lane
        t_search = torch.where(count == 0, torch.ones_like(z),
                               increase * s["stepsize"])
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        m_cub = _cubicmin(low, s["v_low"], s["s_low"], high, s["v_high"],
                          s["cref"], s["v_cref"])
        use_cub = (m_cub > left + 0.2 * delta) & (m_cub < right - 0.2 * delta)
        m_quad = _quadmin(low, s["v_low"], s["s_low"], high, s["v_high"])
        use_quad = ~use_cub & (m_quad > left + 0.1 * delta) & (
            m_quad < right - 0.1 * delta)
        middle = torch.where(use_cub, m_cub, s["cref"])
        middle = torch.where(use_quad, m_quad, middle)
        middle = torch.where(~use_cub & ~use_quad, (low + high) / 2.0,
                             middle)
        t = torch.where(found, middle, t_search)

        v, g = value_and_grad(st.fn, st.x + _col(t) * st.u)
        sl = _vdot(g, st.u)
        dec = v - value - slope_rtol * t * slope0
        approx = torch.maximum(sl - (2 * slope_rtol - 1.0) * slope0,
                               v - value - self.approx_dec_rtol
                               * torch.abs(value))
        dec = _nan_to_inf(torch.clamp(torch.minimum(approx, dec), min=0.0))
        curv = _nan_to_inf(torch.clamp(
            torch.abs(sl) - self.curv_rtol * torch.abs(slope0), min=0.0))
        err = torch.maximum(dec, curv)
        ok_dec = dec <= 0.0
        done = err <= 0.0
        nxt = count + 1

        # interval search (Algorithm 3.5)
        hi_new = (dec > 0.0) | ((v >= s["value"]) & (count > 0))
        lo_new = (sl >= 0.0) & ~hi_new
        S = dict(
            found=hi_new | lo_new | done, done=done,
            failed=(nxt >= self.max_steps) & ~done,
            low=torch.where(lo_new, t, s["stepsize"]),
            v_low=torch.where(lo_new, v, s["value"]),
            s_low=torch.where(lo_new, sl, s["slope"]),
            high=torch.where(lo_new, s["stepsize"], t),
            v_high=torch.where(lo_new, s["value"], v),
            s_high=torch.where(lo_new, s["slope"], sl),
            safe=torch.where(ok_dec, t, s["safe"]),
            v_safe=torch.where(ok_dec, v, s["v_safe"]),
            g_safe=torch.where(_col(ok_dec), g, s["g_safe"]))
        S["cref"], S["v_cref"] = S["low"], S["v_low"]

        # zoom (Algorithm 3.6)
        upd_safe = ok_dec & (v < s["v_safe"])
        safe = torch.where(upd_safe, t, s["safe"])
        hi_mid = (dec > 0.0) | (v >= s["v_low"])
        hi_low = (sl * (high - low) >= 0.0) & ~hi_mid
        lo_mid = ~hi_mid
        n_high = torch.where(hi_low, low, torch.where(hi_mid, t, high))
        n_v_high = torch.where(hi_low, s["v_low"],
                               torch.where(hi_mid, v, s["v_high"]))
        n_s_high = torch.where(hi_low, s["s_low"],
                               torch.where(hi_mid, sl, s["s_high"]))
        hi_changed = hi_mid | hi_low
        Z = dict(
            found=found, done=done,
            failed=((nxt >= self.max_steps)
                    | ((delta <= self.interval_threshold) & (safe > 0.0)))
            & ~done,
            low=torch.where(lo_mid, t, low),
            v_low=torch.where(lo_mid, v, s["v_low"]),
            s_low=torch.where(lo_mid, sl, s["s_low"]),
            high=n_high, v_high=n_v_high, s_high=n_s_high,
            cref=torch.where(hi_changed, high, low),
            v_cref=torch.where(hi_changed, s["v_high"], s["v_low"]),
            safe=safe, v_safe=torch.where(upd_safe, v, s["v_safe"]),
            g_safe=torch.where(_col(upd_safe), g, s["g_safe"]))

        new = dict(count=nxt, stepsize=t, value=v, grad=g, slope=sl,
                   dec=dec, curv=curv)
        for k in S:
            new[k] = torch.where(found if S[k].dim() == 1 else _col(found),
                                 Z[k], S[k])
        # a lane that failed takes its safe step if it has one (or stays
        # put when even the first trial left the domain)
        take_safe = new["failed"] & ((new["safe"] > 0.0)
                                     | torch.isinf(new["dec"]))
        new["stepsize"] = torch.where(take_safe, new["safe"], new["stepsize"])
        new["value"] = torch.where(take_safe, new["v_safe"], new["value"])
        new["grad"] = torch.where(_col(take_safe), new["g_safe"],
                                  new["grad"])
        # every value of `new` is computed before the state is written
        for k, val in new.items():
            _put(s[k], active, val)
        return self._active().any()

    def finish(self) -> None:
        st, s = self.st, self.s
        st.lr.copy_(s["stepsize"])
        st.value.copy_(s["value"])
        st.grad.copy_(s["grad"])


# -- the optimizer loop ----------------------------------------------------------

class _Lbfgs:
    """One stage's L-BFGS state, every buffer allocated once, and its
    iteration's pieces."""

    def __init__(self, fn: Objective, x0: torch.Tensor, memory_size: int,
                 linesearch: str):
        self.fn = fn
        self.x = x0.detach().clone()
        B = self.x.shape[0]
        self.mem = _Memory(self.x, memory_size)
        self.value = torch.full((B,), float("inf"), dtype=self.x.dtype,
                                device=self.x.device)
        self.grad = torch.zeros_like(self.x)
        self.lr = torch.ones_like(self.value)
        self.u = torch.zeros_like(self.x)
        self.search = (_Zoom(self) if linesearch == "zoom"
                       else _Backtracking(self))

    def start(self) -> torch.Tensor:
        """Whether any lane holds no finite value (it is evaluated)."""
        return (~torch.isfinite(self.value)).any()

    def reeval(self) -> None:
        stale = ~torch.isfinite(self.value)
        v, g = value_and_grad(self.fn, self.x)
        _put(self.value, stale, v)
        _put(self.grad, stale, g)

    def begin(self) -> None:
        """The direction and the line search's first state, in which
        every lane searches."""
        torch.neg(self.mem.direction(self.x, self.grad), out=self.u)
        self.search.begin()

    def finish(self) -> None:
        self.search.finish()
        self.x.add_(_col(self.lr) * self.u)


def minimize(fn: Objective, x0: torch.Tensor, num_iter: int,
             memory_size: int = 8, linesearch: str = "zoom",
             program: Optional[step_graph.PhaseProgram] = None,
             key: tuple = ("lbfgs",), rounds: Optional[List[int]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """num_iter L-BFGS steps on every lane of x0 [B, D]. Returns the
    final x [B, D] and the value at the start of each step [num_iter, B]
    (the reference's scan history).

    `program` runs the pieces of each iteration (eager without one),
    each captured once per `key` + (piece,) on the graph route; `rounds`,
    if given, gets each iteration's line-search rounds."""
    if linesearch not in ("zoom", "backtracking"):
        raise ValueError(f"linesearch={linesearch!r}")
    program = program or step_graph.eager(x0.device)
    st = _Lbfgs(fn, x0, memory_size, linesearch)
    search = st.search
    hist = torch.empty((num_iter,) + st.value.shape, dtype=st.value.dtype,
                       device=st.value.device)
    for i in range(num_iter):
        if program.gate(program.call(key + ("start",), st.start)):
            program.call(key + ("reeval",), st.reeval)
        hist[i].copy_(st.value)
        program.call(key + ("begin",), st.begin)
        # every lane searches at the start, so the first round runs
        # unread; each later one runs while its predecessor's flag says
        # some lane still searches
        n = 0
        while n < search.cap:
            n += 1
            if not program.gate(program.call(key + ("round",),
                                             search.round)):
                break
        program.call(key + ("finish",), st.finish)
        if rounds is not None:
            rounds.append(n)
    return st.x, hist
