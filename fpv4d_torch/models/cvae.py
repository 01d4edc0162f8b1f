"""Scene-conditioned CVAE over flat body parameters (port of
fpv4d/models/cvae.py, the reference's HumanCVAE network).

Encoder and decoder MLPs with swish activations and residual links map
(a 72-d body vector, a 128-d scene latent) to and from a 64-d latent.
The pipeline does not use the network (SURVEY.md C4); it is here in
full, functional form, on a plain dict of tensors with the reference's
keys (weights stored [in, out]).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

LATENT_D = 64
N_DIM_BODY = 72
N_DIM_SCENE = 128


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def random_params(latent_d: int = LATENT_D, n_dim_body: int = N_DIM_BODY,
                  n_dim_scene: int = N_DIM_SCENE, seed: int = 0,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Uniform(+-1/sqrt(fan_in)) weights and zero biases, drawn from
    np.random.RandomState(seed) in the reference's order, so both
    packages get the same weights for the same seed."""
    rng = np.random.RandomState(seed)

    def lin(fi, fo):
        s = 1.0 / np.sqrt(fi)
        return (torch.as_tensor(rng.uniform(-s, s, (fi, fo)).astype(
                    np.float32), device=device),
                torch.zeros(fo, dtype=torch.float32, device=device))

    n_in = n_dim_body + n_dim_scene
    p = {}
    p["enc_fc1_w"], p["enc_fc1_b"] = lin(n_in, latent_d)
    p["enc_fc2_w"], p["enc_fc2_b"] = lin(latent_d, latent_d)
    p["enc_fc3_w"], p["enc_fc3_b"] = lin(latent_d, latent_d)
    p["enc_mu_w"], p["enc_mu_b"] = lin(latent_d, latent_d)
    p["enc_ls_w"], p["enc_ls_b"] = lin(latent_d, latent_d)
    p["dec_fc1_w"], p["dec_fc1_b"] = lin(latent_d + n_dim_scene, latent_d)
    p["dec_fc2_w"], p["dec_fc2_b"] = lin(latent_d, latent_d)
    p["dec_fc3_w"], p["dec_fc3_b"] = lin(latent_d, n_dim_body)
    return p


def encode(p: Dict[str, torch.Tensor], x_body: torch.Tensor,
           z_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(body [B,72], scene [B,128]) -> (mu, logsigma2), with the
    residual links of the reference network."""
    h = torch.cat([x_body, z_s], dim=-1)
    h = swish(h @ p["enc_fc1_w"] + p["enc_fc1_b"])
    h = swish(h @ p["enc_fc2_w"] + p["enc_fc2_b"]) + h
    h = swish(h @ p["enc_fc3_w"] + p["enc_fc3_b"]) + h
    mu = h @ p["enc_mu_w"] + p["enc_mu_b"]
    logsigma2 = h @ p["enc_ls_w"] + p["enc_ls_b"]
    return mu, logsigma2


def decode(p: Dict[str, torch.Tensor], z: torch.Tensor, z_s: torch.Tensor,
           dropout_ratio: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(latent [B,64], scene [B,128]) -> body [B,72].

    dropout_ratio > 0 with an explicit `generator` applies inverted
    dropout after the first two decoder layers (keep 1 - p, scale the
    kept by 1 / (1 - p)); with no generator it is the identity, the
    inference mode, as the reference is with rng=None."""
    h = torch.cat([z, z_s], dim=-1)

    def drop(x):
        if dropout_ratio <= 0.0 or generator is None:
            return x
        keep = 1.0 - dropout_ratio
        m = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype) < keep
        return torch.where(m, x / keep, torch.zeros_like(x))

    h = drop(swish(h @ p["dec_fc1_w"] + p["dec_fc1_b"]))
    h = drop(swish(h @ p["dec_fc2_w"] + p["dec_fc2_b"]) + h)
    return h @ p["dec_fc3_w"] + p["dec_fc3_b"]


def forward(p: Dict[str, torch.Tensor], x_body: torch.Tensor,
            eps: torch.Tensor, z_s: torch.Tensor,
            dropout_ratio: float = 0.0,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reparameterized autoencode -> (body, mu, logsigma2)."""
    mu, logsigma2 = encode(p, x_body, z_s)
    z = eps * torch.exp(logsigma2 / 2.0) + mu
    return decode(p, z, z_s, dropout_ratio, generator), mu, logsigma2


def kl_loss(mu: torch.Tensor, logsigma2: torch.Tensor) -> torch.Tensor:
    """Standard VAE KL(q || N(0, I)) term for training the CVAE."""
    return 0.5 * torch.mean(torch.sum(
        torch.exp(logsigma2) + mu ** 2 - 1.0 - logsigma2, dim=-1))
