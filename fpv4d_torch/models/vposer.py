"""VPoser v1 decoder (port of fpv4d/models/vposer.py).

32-d latent -> Linear(512) -> leaky_relu(0.2) -> Linear(512) ->
leaky_relu(0.2) -> Linear(21*6) -> 6D rotation decode. Parameters are a
plain dict of tensors with the reference's keys (w1, b1, w2, b2, w3,
b3; weights stored [in, out]).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fpv4d_torch.core.rotations import rot6d_to_aa, rot6d_to_matrot
from fpv4d_torch.utils import observability as OBS

LATENT_DIM = 32
HIDDEN_DIM = 512
NUM_JOINTS = 21

# 6D code of the identity rotation (first two columns of I, row-major)
_IDENT6 = np.array([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], np.float32)


def random_params(seed: int = 0, scale: float = 0.05,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Deterministic random decoder weights from a numpy seed (the same
    draws as the reference), with the output bias at identity rotations."""
    rng = np.random.RandomState(seed)

    def lin(fan_in, fan_out, s):
        w = rng.randn(fan_in, fan_out).astype(np.float32)
        w *= s / np.sqrt(fan_in)
        return w, np.zeros(fan_out, dtype=np.float32)

    w1, b1 = lin(LATENT_DIM, HIDDEN_DIM, 1.0)
    w2, b2 = lin(HIDDEN_DIM, HIDDEN_DIM, 1.0)
    w3, b3 = lin(HIDDEN_DIM, NUM_JOINTS * 6, scale)
    b3 = b3 + np.tile(_IDENT6, NUM_JOINTS)
    arrays = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def params_from_torch_state_dict(sd, device="cpu"
                                 ) -> Dict[str, torch.Tensor]:
    """Convert a human_body_prior VPoser v1 state dict (keys
    bodyprior_dec_fc1/fc2/out) to decoder params."""
    def arr(v):
        return torch.tensor(np.asarray(v, dtype=np.float32),
                            device=device)

    return {
        "w1": arr(sd["bodyprior_dec_fc1.weight"]).T.contiguous(),
        "b1": arr(sd["bodyprior_dec_fc1.bias"]),
        "w2": arr(sd["bodyprior_dec_fc2.weight"]).T.contiguous(),
        "b2": arr(sd["bodyprior_dec_fc2.bias"]),
        "w3": arr(sd["bodyprior_dec_out.weight"]).T.contiguous(),
        "b3": arr(sd["bodyprior_dec_out.bias"]),
    }


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """leaky ReLU with the reference's derivative at 0: JAX's
    where(x >= 0, x, slope*x) has slope 1 there, F.leaky_relu's
    backward the negative slope. A zero latent over zero biases (the
    keypoint fit's start) puts every hidden unit exactly at 0."""
    return torch.where(x >= 0, x, slope * x)


def decode(params: Dict[str, torch.Tensor], latent: torch.Tensor,
           output_type: str = "aa") -> torch.Tensor:
    """latent [..., 32] -> body pose: 'aa' [..., 63] or 'matrot'
    [..., 21, 3, 3] (the vposer section of utils/observability.py)."""
    latent = OBS.mark("vposer", latent)
    h = _leaky_relu(latent @ params["w1"] + params["b1"], 0.2)
    h = _leaky_relu(h @ params["w2"] + params["b2"], 0.2)
    r6 = h @ params["w3"] + params["b3"]
    r6 = r6.reshape(r6.shape[:-1] + (NUM_JOINTS, 6))
    if output_type == "matrot":
        return OBS.mark("vposer", rot6d_to_matrot(r6), end=True)
    aa = rot6d_to_aa(r6)
    return OBS.mark("vposer", aa.reshape(aa.shape[:-2] + (NUM_JOINTS * 3,)),
                    end=True)


def latent_prior_loss(latent: torch.Tensor) -> torch.Tensor:
    """mean(latent^2) — the VPoser L2 prior."""
    return torch.mean(latent ** 2)
