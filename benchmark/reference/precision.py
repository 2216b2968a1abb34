"""Precision of the reference's products.

:func:`float32` turns TF32 off for matmuls and convolutions while the
reference runs and restores the flags after.  ``Matmul`` is a product
``x @ w.T``; ``Matmul(fp8=True)`` rounds both operands to float8 e4m3 first,
each scaled by its own largest magnitude (per tensor, to e4m3's 448), and
multiplies in float32: the reference computed one precision below the bf16
the configuration serves in, which is the control of a cell without an
int8 path of its own.
"""

from __future__ import annotations

import contextlib

import torch

_E4M3_MAX = 448.0


@contextlib.contextmanager
def float32():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32;
    the rounding passes the gradient straight through."""
    xf = x.float()
    with torch.no_grad():
        scale = xf.abs().amax().clamp_min(1e-30) / _E4M3_MAX
        q = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return xf + (q - xf).detach()


class Matmul:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w^T`` over the last two axes, ``w`` as (..., out, in)."""
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return torch.matmul(x, w.transpose(-1, -2))
