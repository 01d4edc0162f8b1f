"""The FLOPs of a clip solve, counted from the benchmark's own plain
objective (``perfbench/reference``), so the count is the same whatever
implements the solve.

Per phase: the matmul-class FLOPs (``FlopCounterMode``: mm, bmm, addmm,
convolutions; no elementwise op) of one forward of the phase's loss and
its gradient, at the configuration's shapes, plus 2 FLOPs per
nearest-neighbour (query, point) pair of the phase's contact search
(one fused multiply-add's worth of the f32 peak, which counts an FMA as
two: the least a search can issue per pair). Times the phase's steps.
dct_a counts its step on joints computed once per phase; the contact
refreshes, the SDF and the planted-foot detection are left out.

``fpv4d_torch/utils/cost.py`` counts 8 FLOPs a pair over the program's
own loss: at K2's shapes that count would pass the peak once K2 ran
1.6 times faster than today, which no share may.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import objective as O

FLOPS_PER_PAIR = 2


def phase_steps(cfg: dict, mode: str) -> Dict[str, int]:
    """Each phase of a `mode` solve and its steps, from the
    configuration."""
    n_a = int(cfg["num_iter"] * cfg["stage_split"])
    if mode == "local":
        return {"local_a": n_a, "local_b": cfg["num_iter"] - n_a,
                "skate": int(cfg["contact_phase_frac"] * cfg["num_iter"])}
    if mode == "global":
        return {"global_a": n_a, "global_b": cfg["num_iter"] - n_a}
    n_d = int(cfg["num_iter_dct"] * cfg["dct_split"])
    return {"dct_a": n_d, "dct_b": cfg["num_iter_dct"] - n_d}


def step_flops(problem: "O.Problem", phase: str, start: dict) -> float:
    """Counted FLOPs of one step of `phase` at `start`'s shapes."""
    cfg = problem.cfg
    leaves = dict(zip(O.LEAVES, O.leaves_of(start)))
    st = {k: (v if k in O.MASKS[phase] else v.detach())
          for k, v in leaves.items()}
    pairs = []

    def nn(pts, tables):
        if tables is not None:
            pairs.append(pts.shape[0] * pts.shape[1] * cfg["compact"])
        else:
            pairs.append(pts[..., 0].numel() * problem.scene.shape[0])
        return (pts * 0.0).sum(-1)

    tables = object() if (phase in O.CONTACT_PHASES
                          and cfg["nn_impl"] == "grid") else None
    joints = None
    if phase == "dct_a":
        with torch.no_grad():
            _, joints = O.forward_world(problem.body, start["body_6d"],
                                        start["scale"], start["camera_ext"],
                                        problem.vids, with_verts=False)
    T = start["body_6d"].shape[0]
    w_right = torch.full((T,), 0.75, device=start["body_6d"].device)
    with FlopCounterMode(display=False) as fc:
        loss = problem.loss(phase, st, start["target"], start["fw"], tables,
                            w_right, joints, nn=nn)
        torch.autograd.grad(loss, [leaves[k] for k in O.MASKS[phase]],
                            allow_unused=True)
    return float(fc.get_total_flops() + FLOPS_PER_PAIR * sum(pairs))


def solve_flops(problem: "O.Problem", mode: str, start: dict
                ) -> Dict[str, float]:
    """Counted FLOPs of each phase of a `mode` solve (steps x a step's)."""
    return {ph: n * step_flops(problem, ph, start)
            for ph, n in phase_steps(problem.cfg, mode).items()}
