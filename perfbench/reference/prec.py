"""The precision of the reference's products.

Every matrix product of the reference goes through ``mm`` or
``einsum``. In float32 (the configuration's precision: the program runs
float32 with TF32 off) they are plain torch products with TF32 off. The
control (``precision("tf32")``) rounds each operand to TF32 first (10
mantissa bits, round to nearest, as the tensor cores' conversion does)
and multiplies in float32, the same on any device, so the control reads
the same on the card and on the CPU.
"""
from __future__ import annotations

import contextlib

import torch

_MODE = ["f32"]


@contextlib.contextmanager
def precision(mode: str):
    """Run the reference's products in `mode` ('f32' or 'tf32')."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}: 'f32' or 'tf32'")
    old = _MODE[0]
    _MODE[0] = mode
    try:
        yield
    finally:
        _MODE[0] = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (nearest, ties away), kept
    in float32; the rounding passes the gradient straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def _ops(ops):
    if _MODE[0] == "f32":
        return ops
    return tuple(to_tf32(o) for o in ops)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (broadcasting as torch.matmul) in the current precision."""
    a, b = _ops((a, b))
    return torch.matmul(a, b)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """torch.einsum in the current precision."""
    return torch.einsum(eq, *_ops(ops))


def f32_products():
    """Turn TF32 off for torch's own products (the reference's float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
