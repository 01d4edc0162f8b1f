"""Adam in optax's arithmetic order, its whole state on the device (the
counterpart of ``optax.adam(lr)``, which fpv4d/solve/clip_solve.py:260
makes once per fit).

optax 0.2.6 chains ``scale_by_adam`` and ``scale_by_learning_rate``
(optax/_src/transform.py); per leaf p with gradient g, one step is

    mu     = (1 - b1) g   + b1 mu
    nu     = (1 - b2) g^2 + b2 nu
    count  = count + 1
    mu_hat = mu / (1 - b1^count)
    nu_hat = nu / (1 - b2^count)
    p      = p + (-lr) (mu_hat / (sqrt(nu_hat) + eps))

Every operation here is that one, in that order, over all leaves at once
(``torch._foreach_*``). ``count`` is an int32 tensor on the leaves'
device and the moments are allocated once, so a step reads nothing from
the host: it can be captured in a CUDA graph (solve/step_graph.py) and
runs the same code on the CPU. The clip solve keeps every leaf's
``.grad`` allocated and zeroes it in place, so a leaf a phase does not
reach takes an Adam step on its moments with a zero gradient, as optax
does with the reference's masked (zero) gradients.

Two routes, by the leaves' device, never one as the other's fallback:
CPU leaves take torch's foreach ops (``foreach_step``, the plain route,
counted ``adam/plain`` while tracing is on); CUDA leaves take one
hand-written kernel over every leaf (ops/adam_cuda.py,
csrc/adam_step.cu; counted ``adam/cuda``), which gives the plain
route's bits on the card in one launch in place of 22. On the kernel route the step also writes
each gradient 0 after reading it, so the gradients are 0 from
construction on except between a backward and the step that takes it,
and ``zero_grad`` launches nothing: every caller's step is zero_grad,
backward, (a gradient sum across ranks), step, and nothing reads a
gradient after the step. The kernel's table holds the addresses of the
leaves, gradients and moments as they are at construction: they are
updated in place, never replaced.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from fpv4d_torch.ops import adam_cuda
from fpv4d_torch.utils import observability as OBS


class Adam:
    """optax.adam over a fixed list of leaf tensors. ``mu``, ``nu`` and
    ``count`` may be given (views of another Adam's state, see
    ``select``); otherwise they start at zero."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu: Optional[List[torch.Tensor]] = None,
                 nu: Optional[List[torch.Tensor]] = None,
                 count: Optional[torch.Tensor] = None):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        with torch.no_grad():
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.mu = mu if mu is not None else [torch.zeros_like(p)
                                                 for p in self.params]
            self.nu = nu if nu is not None else [torch.zeros_like(p)
                                                 for p in self.params]
            self.count = (count if count is not None else torch.zeros(
                (), dtype=torch.int32, device=self.params[0].device))
            self._grads = [p.grad for p in self.params]
            self._table = None
            if self.count.is_cuda:
                if self.count.dtype != torch.int32 or any(
                        p.device != self.count.device for p in self.params):
                    raise ValueError("the Adam kernel takes an int32 count "
                                     "on the leaves' card")
                torch._foreach_zero_(self._grads)
                self._table = adam_cuda.leaf_table(self.params, self._grads,
                                                   self.mu, self.nu)

    @torch.no_grad()
    def zero_grad(self) -> None:
        """Every leaf's gradient set to 0 in place (an adam section of
        utils/observability.py); on the kernel route the last step has
        left them 0 already, and nothing is launched."""
        if self._table is not None:
            return
        with OBS.section("adam", self.count.device):
            torch._foreach_zero_([p.grad for p in self.params])

    @torch.no_grad()
    def reset(self) -> None:
        """The state of a new Adam over the same leaves, made in place (a
        captured step goes on reading these tensors): moments, count and
        gradients 0."""
        torch._foreach_zero_(self.mu + self.nu
                             + [p.grad for p in self.params])
        self.count.zero_()

    @torch.no_grad()
    def step(self) -> None:
        """One step of every leaf (an adam section of
        utils/observability.py): the kernel for CUDA leaves, the foreach
        route for CPU leaves."""
        if self._table is None:
            OBS.count("adam/plain")
            with OBS.section("adam", self.count.device):
                foreach_step(self.params, [p.grad for p in self.params],
                             self.mu, self.nu, self.count, self.lr, self.b1,
                             self.b2, self.eps)
            return
        if any(p.grad is not g for p, g in zip(self.params, self._grads)):
            raise RuntimeError("a leaf's .grad was replaced: the Adam kernel "
                               "steps the gradients its table was built "
                               "with")
        with OBS.section("adam", self.count.device):
            adam_cuda.step(self._table, self.count, self.lr, self.b1,
                           self.b2, self.eps)

    def select(self, sl: slice) -> "Adam":
        """An Adam over rows `sl` of every leaf's leading axis (a fleet's
        clips): its leaves, gradients and moments are views of this one's,
        so its steps advance those rows in place; its count starts as a
        copy of this one's, which the caller advances once for all its
        row slices."""
        params = []
        for p in self.params:
            q = p.detach()[sl].requires_grad_(True)
            q.grad = p.grad[sl]
            params.append(q)
        return Adam(params, self.lr, self.b1, self.b2, self.eps,
                    mu=[m[sl] for m in self.mu], nu=[v[sl] for v in self.nu],
                    count=self.count.clone())

    def state_dict(self) -> Dict:
        """torch.optim.Adam's layout: per leaf index its step count and
        moments ("step", "exp_avg", "exp_avg_sq"), and one parameter group
        with the hyperparameters (the tensors are this Adam's own)."""
        return {"state": {i: {"step": self.count, "exp_avg": m,
                              "exp_avg_sq": v}
                          for i, (m, v) in enumerate(zip(self.mu, self.nu))},
                "param_groups": [{"lr": self.lr, "betas": (self.b1, self.b2),
                                  "eps": self.eps,
                                  "params": list(range(len(self.params)))}]}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        """Copy a state_dict's count and moments into this Adam's tensors
        (in place: a captured step goes on reading them) and take its
        hyperparameters."""
        st = sd["state"]
        if sorted(st) != list(range(len(self.params))):
            raise ValueError(f"a state of {len(st)} leaves for an Adam over "
                             f"{len(self.params)}")
        self.count.copy_(st[0]["step"])
        for i, (m, v) in enumerate(zip(self.mu, self.nu)):
            m.copy_(st[i]["exp_avg"])
            v.copy_(st[i]["exp_avg_sq"])
        group = sd["param_groups"][0]
        self.lr, self.eps = group["lr"], group["eps"]
        self.b1, self.b2 = group["betas"]


@torch.no_grad()
def foreach_step(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], count: torch.Tensor, lr: float,
                 b1: float, b2: float, eps: float) -> None:
    """The plain route: one step of the leaves, moments and count in
    place by torch's foreach ops, every operation of the module's
    docstring in its order (on any device: on the card it is the
    kernel's yardstick, bit for bit)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    g2 = torch._foreach_mul(grads, grads)
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
