"""Checkpoint / resume (port of fpv4d/utils/checkpoint.py).

Stage-granular resume is the per-frame pkl layout of io/body_pkl.py:
re-running a stage resumes from its input directory
(``latest_stage_output``). Mid-optimization checkpoints of the solver
(decision variables, Adam state, step count) are ``torch.save`` files
of ``{"state", "opt_state", "step"}``; the Adam state is
solve/adam.py's ``state_dict`` (torch.optim.Adam's layout: each leaf's
moments and the shared step count, on the solver's device), which
``Adam.load_state_dict`` copies back in place. The reference writes
orbax checkpoints instead; this module neither reads nor writes those.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_solver_state(path: str, state: Any, optimizer, step: int = 0
                      ) -> None:
    """Write the state's tensors (a NamedTuple such as ClipState), the
    optimizer's state_dict and the step count to `path`."""
    ckpt = {"state": {k: v.detach().cpu()
                      for k, v in state._asdict().items()},
            "opt_state": optimizer.state_dict(), "step": int(step)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_solver_state(path: str, device="cpu"
                      ) -> Tuple[Dict[str, torch.Tensor], Dict, int]:
    """(state tensors by leaf name on `device`, optimizer state_dict,
    step). Load the state_dict into an Adam over the same leaves with
    ``Adam.load_state_dict`` (ClipSolver.make_optimizer of the loaded
    state), then run the phases that follow the checkpoint's."""
    ckpt = torch.load(path, map_location=device, weights_only=True)
    return ckpt["state"], ckpt["opt_state"], int(ckpt["step"])


def latest_stage_output(fit_path: str) -> Optional[str]:
    """Newest frame pkl under a stage directory, or None if the stage
    has not run."""
    pkls = sorted(glob.glob(os.path.join(fit_path, "**", "*.pkl"),
                            recursive=True))
    return pkls[-1] if pkls else None
