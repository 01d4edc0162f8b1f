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
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

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


# -- the L-BFGS direction (optax.scale_by_lbfgs) -------------------------------

class _Memory:
    """scale_by_lbfgs's state: the previous params and gradient and the
    last m differences, a ring indexed by the step count."""

    def __init__(self, x: torch.Tensor, m: int):
        self.m, self.count = m, 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dw = torch.zeros((m,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros((m, x.shape[0]), dtype=x.dtype,
                               device=x.device)

    def direction(self, x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """Store (x - x_prev, g - g_prev), then return P g."""
        m, k = self.m, self.count
        idx, prev = k % m, (k - 1) % m
        dw, du = x - self.params, grad - self.updates
        vd = _vdot(du, dw)
        w = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        if k == 0:
            dw, du, w = (torch.zeros_like(dw), torch.zeros_like(du),
                         torch.zeros_like(w))
        self.dw[prev], self.du[prev], self.rho[prev] = dw, du, w
        if k > 0:
            den = _vdot(du, du)
            scale = torch.where(den > 0.0, _vdot(du, dw) / den,
                                torch.ones_like(den))
        else:
            # first step: a capped reciprocal of the gradient norm
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=-1),
                                max=1.0)
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = grad, [None] * m
        for j in reversed(range(m)):
            i = order[j]
            alphas[j] = self.rho[i] * _vdot(self.dw[i], vec)
            vec = vec + _col(-alphas[j]) * self.du[i]
        vec = _col(scale) * vec
        for j in range(m):
            i = order[j]
            beta = self.rho[i] * _vdot(self.du[i], vec)
            vec = vec + _col(alphas[j] - beta) * self.dw[i]
        self.params, self.updates, self.count = x, grad, k + 1
        return vec


# -- optax.scale_by_backtracking_linesearch (store_grad=True) ------------------

def _backtracking(fn: Objective, x, u, value, grad, lr_prev,
                  max_steps: int = BACKTRACK_MAX_STEPS,
                  slope_rtol: float = 1e-4, decrease: float = 0.8,
                  increase: float = 1.5, max_lr: float = 1.0):
    """Armijo backtracking per lane. Returns (learning rate [B], value [B]
    and gradient [B, D] at the last point each lane evaluated)."""
    slope = _vdot(u, grad)
    lr = torch.clamp(increase * lr_prev, max=max_lr)
    new_value = value.clone()
    err = torch.full_like(value, float("inf"))
    it = torch.zeros_like(value, dtype=torch.int64)
    while True:
        active = ~(err <= 0.0) & (it <= max_steps)
        if not bool(active.any()):
            break
        lr_t = torch.where(it > 0, decrease * lr, lr)
        v = fn(x + _col(lr_t) * u).detach()
        e = torch.clamp(_nan_to_inf(v - value - lr_t * slope_rtol * slope),
                        min=0.0)
        lr = torch.where(active, lr_t, lr)
        new_value = torch.where(active, v, new_value)
        err = torch.where(active, e, err)
        it = it + active.to(it.dtype)
    # every lane's gradient is taken at the last point it evaluated (its
    # search ends there, accepted or at the step limit)
    _, new_grad = value_and_grad(fn, x + _col(lr) * u)
    lr = torch.where(torch.isinf(err), torch.zeros_like(lr), lr)
    return lr, new_value, new_grad


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


def _zoom(fn: Objective, x, u, value, grad,
          max_steps: int = ZOOM_MAX_STEPS, slope_rtol: float = 1e-4,
          curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
          increase: float = 2.0, interval_threshold: float = 1e-5):
    """The zoom line search per lane, first guess 1 and no largest step.
    Returns (step size [B], value [B] and gradient [B, D] there)."""
    z = torch.zeros_like(value)
    f = torch.zeros_like(value, dtype=torch.bool)
    slope0 = _vdot(u, grad)
    s = dict(count=torch.zeros_like(value, dtype=torch.int64),
             stepsize=z.clone(), value=value.clone(), grad=grad.clone(),
             slope=slope0.clone(), dec=torch.full_like(value, float("inf")),
             curv=torch.full_like(value, float("inf")),
             found=f.clone(), done=f.clone(), failed=f.clone(),
             low=z.clone(), v_low=value.clone(), s_low=slope0.clone(),
             high=z.clone(), v_high=value.clone(), s_high=slope0.clone(),
             cref=z.clone(), v_cref=value.clone(),
             safe=z.clone(), v_safe=value.clone(), g_safe=grad.clone())
    while True:
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            break
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

        v, g = value_and_grad(fn, x + _col(t) * u)
        sl = _vdot(g, u)
        dec = v - value - slope_rtol * t * slope0
        approx = torch.maximum(sl - (2 * slope_rtol - 1.0) * slope0,
                               v - value - approx_dec_rtol * torch.abs(value))
        dec = _nan_to_inf(torch.clamp(torch.minimum(approx, dec), min=0.0))
        curv = _nan_to_inf(torch.clamp(
            torch.abs(sl) - curv_rtol * torch.abs(slope0), min=0.0))
        err = torch.maximum(dec, curv)
        ok_dec = dec <= 0.0
        done = err <= 0.0
        nxt = count + 1

        # interval search (Algorithm 3.5)
        hi_new = (dec > 0.0) | ((v >= s["value"]) & (count > 0))
        lo_new = (sl >= 0.0) & ~hi_new
        S = dict(
            found=hi_new | lo_new | done, done=done,
            failed=(nxt >= max_steps) & ~done,
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
            failed=((nxt >= max_steps) | ((delta <= interval_threshold)
                                          & (safe > 0.0))) & ~done,
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
            sel = found if S[k].dim() == 1 else _col(found)
            new[k] = torch.where(sel, Z[k], S[k])
        # a lane that failed takes its safe step if it has one (or stays
        # put when even the first trial left the domain)
        take_safe = new["failed"] & ((new["safe"] > 0.0)
                                     | torch.isinf(new["dec"]))
        new["stepsize"] = torch.where(take_safe, new["safe"], new["stepsize"])
        new["value"] = torch.where(take_safe, new["v_safe"], new["value"])
        new["grad"] = torch.where(_col(take_safe), new["g_safe"],
                                  new["grad"])
        for k, val in new.items():
            sel = active if val.dim() == 1 else _col(active)
            s[k] = torch.where(sel, val, s[k])
    return s["stepsize"], s["value"], s["grad"]


# -- the optimizer loop ----------------------------------------------------------

def minimize(fn: Objective, x0: torch.Tensor, num_iter: int,
             memory_size: int = 8, linesearch: str = "zoom"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """num_iter L-BFGS steps on every lane of x0 [B, D]. Returns the
    final x [B, D] and the value at the start of each step [num_iter, B]
    (the reference's scan history)."""
    if linesearch not in ("zoom", "backtracking"):
        raise ValueError(f"linesearch={linesearch!r}")
    x = x0.detach().clone()
    mem = _Memory(x, memory_size)
    B = x.shape[0]
    value = torch.full((B,), float("inf"), dtype=x.dtype, device=x.device)
    grad = torch.zeros_like(x)
    lr = torch.ones(B, dtype=x.dtype, device=x.device)
    hist = torch.empty((num_iter, B), dtype=x.dtype, device=x.device)
    for i in range(num_iter):
        stale = ~torch.isfinite(value)
        if bool(stale.any()):
            v, g = value_and_grad(fn, x)
            value = torch.where(stale, v, value)
            grad = torch.where(_col(stale), g, grad)
        hist[i] = value
        u = -mem.direction(x, grad)
        if linesearch == "zoom":
            lr, value, grad = _zoom(fn, x, u, value, grad)
        else:
            lr, value, grad = _backtracking(fn, x, u, value, grad, lr)
        x = x + _col(lr) * u
    return x, hist
