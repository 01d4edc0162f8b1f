"""Fitting monitor: NaN/Inf detection and ftol early stopping (the
port's own copy of fpv4d/utils/monitor.py, which is NumPy only).

The reference carries SMPLify-X's FittingMonitor (C12, vis.py:116-272):
a NaN/Inf loss stop (vis.py:180-185) and a relative-change convergence
stop (vis.py:188-195, dead there because utils.rel_change is
unimported; SURVEY.md section 0 item 4). Here both work, on the host
around whole phase runs, plus a vectorized `steps_until_converged` for
reading loss histories after the fact.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


def rel_change(prev: float, curr: float) -> float:
    """|prev-curr| / max(|prev|, |curr|, 1) — upstream SMPLify-X's
    convergence measure."""
    return abs(prev - curr) / max(abs(prev), abs(curr), 1.0)


@dataclass
class FittingMonitor:
    """Host-side guardrail around staged optimization.

    Feed per-step (or per-phase) losses via update(); it reports when
    to stop: NaN/Inf immediately, ftol when the relative improvement
    stalls, maxiters as a hard cap."""
    ftol: float = 2e-9
    maxiters: int = 100_000
    prev_loss: Optional[float] = field(default=None, init=False)
    steps: int = field(default=0, init=False)
    stopped_reason: Optional[str] = field(default=None, init=False)

    def update(self, loss: float) -> bool:
        """Returns True if optimization should STOP."""
        loss = float(loss)
        self.steps += 1
        if not np.isfinite(loss):
            self.stopped_reason = "non-finite loss"
            return True
        if self.steps >= self.maxiters:
            self.stopped_reason = "maxiters"
            return True
        if self.prev_loss is not None and \
                rel_change(self.prev_loss, loss) < self.ftol:
            self.stopped_reason = "ftol"
            return True
        self.prev_loss = loss
        return False

    def check_history(self, losses: np.ndarray) -> Tuple[bool, int]:
        """Scan a whole loss history (e.g. one compiled phase's
        output): returns (ok, effective_steps) where ok=False on any
        non-finite value and effective_steps is where ftol would have
        stopped."""
        losses = np.asarray(losses)
        if not np.all(np.isfinite(losses)):
            self.stopped_reason = "non-finite loss"
            return False, int(np.argmax(~np.isfinite(losses)))
        for i in range(1, len(losses)):
            if rel_change(float(losses[i - 1]), float(losses[i])) \
                    < self.ftol:
                return True, i
        return True, len(losses)


def steps_until_converged(losses: np.ndarray, ftol: float = 2e-9) -> int:
    """Vectorized ftol scan over a loss history."""
    losses = np.asarray(losses, dtype=np.float64)
    if len(losses) < 2:
        return len(losses)
    prev, curr = losses[:-1], losses[1:]
    rc = np.abs(prev - curr) / np.maximum.reduce(
        [np.abs(prev), np.abs(curr), np.ones_like(prev)])
    hits = np.where(rc < ftol)[0]
    return int(hits[0] + 1) if len(hits) else len(losses)
