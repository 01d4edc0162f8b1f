"""The comparison that decides a run's `correct`.

A solve is hundreds of Adam steps on L1 terms, whose last bits steer
two implementations apart; so the reference follows the program step by
step instead of solving again. For each phase of a solve that the
window finished, it starts from where the program started that phase —
its own initial state, worked out from the clip's inputs, for the first
phase; the program's state and Adam moments after the phase before
(the solve's checkpoints, ``fit(checkpoint_dir=...)``) for the others —
makes the phase's own inputs again (the candidate tables or the scene
search, the planted-foot weights before the skate phase), runs the
phase's first ``STEPS`` Adam steps and compares the loss before each
with the program's history of that phase, as |program - reference| /
|reference|.

On the card the program runs a phase's first two steps eagerly, then
captures its step as a CUDA graph and replays it for the rest; STEPS
takes in two replayed Adam updates and three replayed forwards (the
contact search inside them), so a replay that updates wrongly, or not
at all, shows. Three numbers are compared:

* ``forward_gap``: the largest gap of a phase's first loss, over every
  phase: the objective, the contact search and its tables (a replayed
  refresh), the detection and the initial state, at the program's own
  phase starts;
* ``first_gap``: the largest gap of the first phase's later losses: its
  Adam from a fresh state, eager and replayed;
* ``step_gap``: the same over every phase after the first: the Adam
  from the moments the program carried into the phase.

``first_gap`` reads higher than ``step_gap`` on sound runs: the first
Adam steps move each coordinate by about the learning rate whatever the
size of its gradient, so a gradient that sums to nearly zero takes its
sign from rounding. What this leaves unchecked, the later replays of a
phase (its steps past STEPS and its later refreshes), replays the
graphs that the compared steps replay.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from perfbench.counts.flops import phase_steps
from perfbench.reference import objective as O
from perfbench.reference.prec import precision

# losses compared a phase: two eager steps, then three of replays
STEPS = 5
# each mode's phases: (the history's and checkpoint's name, the phase)
MODE_PHASES = {"local": (("local_a", "local_a"), ("local_b", "local_b"),
                         ("local_skate", "skate")),
               "global": (("global_a", "global_a"), ("global_b", "global_b")),
               "dct": (("dct_a", "dct_a"), ("dct_b", "dct_b"))}


def _resume(path: str, problem: "O.Problem"):
    """The program's state and Adam after a phase, from its checkpoint."""
    ck = torch.load(path, map_location=problem.device, weights_only=True)
    leaves = [ck["state"][k].to(torch.float32).clone().requires_grad_(True)
              for k in O.LEAVES]
    st = ck["opt_state"]["state"]
    adam = O.Adam(leaves, problem.cfg["lr"],
                  mu=[st[i]["exp_avg"].clone() for i in range(4)],
                  nu=[st[i]["exp_avg_sq"].clone() for i in range(4)],
                  count=int(st[0]["step"]))
    return dict(zip(O.LEAVES, leaves)), adam


def reference_losses(problem: "O.Problem", mode: str, body_75, cam,
                     ckpt_dir: str, mode_precision: str = "f32"
                     ) -> Dict[str, List[float]]:
    """The reference's losses of the first STEPS steps of each phase (all
    of a shorter phase's), from the program's phase starts, in
    `mode_precision`."""
    steps = phase_steps(problem.cfg, mode)
    out = {}
    with precision(mode_precision):
        init = problem.init(body_75, cam)
        target, fw = init["target"], init["fw"]
        prev = None
        for name, phase in MODE_PHASES[mode]:
            if prev is None:
                leaves = O.leaves_of(init)
                state = dict(zip(O.LEAVES, leaves))
                adam = O.Adam(leaves, problem.cfg["lr"])
            else:
                state, adam = _resume(os.path.join(ckpt_dir, f"{prev}.pt"),
                                      problem)
            w_right = problem.detect(state) if phase == "skate" else None
            out[name] = problem.follow(phase, state, adam, target, fw,
                                       min(STEPS, steps[phase]), w_right)
            prev = name
    return out


def numbers(program: Dict[str, List[float]],
            reference: Dict[str, List[float]]) -> Dict[str, float]:
    """``forward_gap``, ``first_gap`` and ``step_gap`` of one solve; inf
    where a loss is missing or not finite."""
    names = list(reference)
    out = {"forward_gap": 0.0, "step_gap": 0.0, "first_gap": 0.0}
    for j, k in enumerate(names):
        ref = reference[k]
        prog = list(program.get(k, []))[:len(ref)]
        out["forward_gap"] = max(out["forward_gap"],
                                 O.relative_gap(prog[:1], ref[:1]))
        later = "first_gap" if j == 0 else "step_gap"
        if len(ref) > 1:
            out[later] = max(out[later], O.relative_gap(prog[1:], ref[1:]))
    return out
