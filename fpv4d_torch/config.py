"""Configuration dataclasses (port of fpv4d/config.py, same fields and
defaults): the clip solve, the per-frame smoother and the keypoint
fit."""
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


@dataclass(frozen=True)
class FrameFitConfig:
    """Per-frame sequential smoothing (optimization.py:304-327)."""
    num_iter: int = 50
    lr: float = 0.1
    smooth_mult: float = 5.0
    weights: LossWeights = field(default_factory=LossWeights)
    contact_parts: Tuple[str, ...] = (
        "back", "butt", "L_Hand", "R_Hand", "L_Leg", "R_Leg", "thighs")


@dataclass(frozen=True)
class KeypointFitConfig:
    """SMPLify-X-style fit from 2D keypoints (pipeline step 3; focal
    length 694 as the reference's README gives it)."""
    focal_length: float = 694.0
    image_size: Tuple[int, int] = (1280, 720)
    num_iter: int = 120
    lr: float = 0.02
    stages: int = 3
    weight_reproj: float = 1.0
    weight_vposer: float = 0.05
    weight_shape: float = 0.01
    weight_hand: float = 0.01
    weight_expr: float = 0.01
    weight_jaw: float = 0.1
    gmof_rho: float = 100.0
    # 'adam' (staged Adam, the default), 'lbfgs' (one L-BFGS memory and
    # zoom line search over the whole clip's objective) or
    # 'lbfgs_perframe' (an L-BFGS memory and bounded backtracking line
    # search per frame, the frames batched)
    optimizer: str = "adam"
    # kept so the signature matches the reference, whose guard against
    # 'lbfgs_perframe' fires only on a TPU; the port never raises on it
    allow_slow_perframe: bool = False
    lbfgs_memory: int = 8
