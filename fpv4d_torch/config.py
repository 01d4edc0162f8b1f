"""Configuration dataclasses of the clip solve (port of
fpv4d/config.py:11-99, same fields and defaults)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class LossWeights:
    """lossconfig of the reference (global_optimization.py:681-686)."""
    rec: float = 1.0
    vposer: float = 0.001
    contact: float = 0.1
    collision: float = 0.5


@dataclass(frozen=True)
class ClipConfig:
    """Clip-level joint optimization (global_optimization.py)."""
    num_iter: int = 500
    num_iter_dct: int = 10000
    lr: float = 0.005
    scale_init: float = 1.8
    window: int = 60
    dct_num: int = 5
    num_dct_joints: int = 23
    outlier_factor: float = 1.8
    weights: LossWeights = field(default_factory=LossWeights)
    contact_parts: Tuple[str, ...] = ("L_Leg", "R_Leg")
    # stage multipliers
    local_contact_mult: float = 0.2
    global_contact_mult: float = 0.1
    phase_b_smooth_mult: float = 0.5
    dct_mult: float = 10.0
    stage_split: float = 0.8
    contact_phase_frac: float = 0.4
    dct_split: float = 0.95
    # closed-form DCT-coefficient init of c_dct
    dct_closed_form_init: bool = False
    # anti-skate phase: stratified vertex subset size (0 = full mesh)
    skate_subset: int = 0
    # restrict the skate sample to body-subtree-skinned vertices
    skate_body_only: bool = False
    # rebuild the per-frame candidate tables every this-many steps
    contact_refresh_steps: int = 50
    # unique-cell budget per frame for the candidate refresh
    contact_cell_budget: int = 64
    # refresh-time candidate compaction (0 = off)
    contact_compact: int = 0
    # per-step candidate NN: 'auto' is the only value the port has —
    # the hand-written CUDA kernel (ops/cand_cuda.py) for tensors on
    # the card, its plain PyTorch version for tensors on the CPU
    cand_impl: str = "auto"

    def __post_init__(self):
        if self.cand_impl != "auto":
            raise ValueError(
                f"cand_impl={self.cand_impl!r}: the port implements only "
                "'auto' (CUDA kernel on the card, plain version on the CPU)")
