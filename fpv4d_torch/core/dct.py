"""Analytic DCT-II basis (port of fpv4d/core/dct.py)."""
from __future__ import annotations

import numpy as np
import torch


def dct_basis(n: int, k: int, device="cpu") -> torch.Tensor:
    """[n, k] float32 matrix whose columns are the first k orthonormal
    DCT-II basis vectors of length n (computed in float64 on the host,
    like the reference)."""
    t = np.arange(n)[:, None]
    f = np.arange(k)[None, :]
    basis = np.cos(np.pi * (2 * t + 1) * f / (2 * n))
    basis *= np.sqrt(2.0 / n)
    basis[:, 0] /= np.sqrt(2.0)
    return torch.as_tensor(basis.astype(np.float32), device=device)
