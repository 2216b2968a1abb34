"""Separable resampling with PyTorch ``F.interpolate`` semantics.

Counterpart of :mod:`ucod_dpl_tpu.ops.resize`: the same per-axis (out, in)
weight matrices (built once on the host per size pair, numpy, copied from
the JAX module so the two packages agree), applied as two float32 matmuls.
Bilinear is ``align_corners=False`` without antialiasing; bicubic uses
a = -0.75 with clamped taps, as torch does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) row-stochastic matrix of torch bilinear (align_corners=False)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    scale = in_size / out_size
    src = np.maximum(scale * (np.arange(out_size) + 0.5) - 0.5, 0.0)
    x0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    frac = (src - x0).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, x0), 1.0 - frac)
    np.add.at(w, (rows, x1), frac)
    return w


def _cubic_kernel(t: np.ndarray, a: float = -0.75):
    """Cubic convolution coefficients of the 4 taps around fractional t."""

    def k_inner(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k_outer(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return k_outer(t + 1.0), k_inner(t), k_inner(1.0 - t), k_outer(2.0 - t)


@functools.lru_cache(maxsize=256)
def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of torch bicubic (align_corners=False)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    src = scale * (np.arange(out_size) + 0.5) - 0.5  # unclamped for cubic
    x0 = np.floor(src).astype(np.int64)
    coeffs = _cubic_kernel((src - x0).astype(np.float64))
    rows = np.arange(out_size)
    for tap, c in enumerate(coeffs):
        idx = np.clip(x0 - 1 + tap, 0, in_size - 1)
        np.add.at(w, (rows, idx), c.astype(np.float32))
    return w


@functools.lru_cache(maxsize=256)
def _device_weights(kind: str, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode (serving):
    # the cached matrix is shared with differentiated callers (training), and
    # autograd refuses to save an inference tensor for backward
    with torch.inference_mode(False):
        w = (_linear_weights if kind == "linear" else _cubic_weights)(in_size, out_size)
        return torch.from_numpy(w).to(device)


def _apply_separable(x: torch.Tensor, kind: str, size: Tuple[int, int], h_dim: int) -> torch.Tensor:
    """Resample axes ``h_dim`` and ``h_dim + 1`` of ``x`` in float32; the
    result keeps ``x.dtype``."""
    h, w = int(size[0]), int(size[1])
    wh = _device_weights(kind, x.shape[h_dim], h, x.device)
    ww = _device_weights(kind, x.shape[h_dim + 1], w, x.device)
    y = torch.movedim(x.float(), (h_dim, h_dim + 1), (-2, -1))
    y = torch.matmul(torch.matmul(wh, y), ww.t())
    return torch.movedim(y, (-2, -1), (h_dim, h_dim + 1)).to(x.dtype)


def interpolate_bilinear_nhwc(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) tensors (channels stay last)."""
    if x.shape[1] == size[0] and x.shape[2] == size[1]:
        return x
    return _apply_separable(x, "linear", size, 1)


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(x, size, mode='bilinear', align_corners=False)``
    for (..., H, W) tensors, e.g. NCHW; differentiable (two matmuls)."""
    if x.shape[-2] == size[0] and x.shape[-1] == size[1]:
        return x
    return _apply_separable(x, "linear", size, x.dim() - 2)


def interpolate_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(x, size, mode='bicubic', align_corners=False)``
    for (..., H, W) tensors."""
    if x.shape[-2] == size[0] and x.shape[-1] == size[1]:
        return x
    return _apply_separable(x, "cubic", size, x.dim() - 2)


@functools.lru_cache(maxsize=256)
def _linear_taps(in_size: int, out_size: int):
    """(lo_idx, hi_idx, frac) per output position of one axis."""
    if in_size == 1:
        z = np.zeros(out_size, np.int64)
        return z, z, np.zeros(out_size, np.float32)
    scale = in_size / out_size
    src = np.maximum(scale * (np.arange(out_size) + 0.5) - 0.5, 0.0)
    x0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    return x0, x1, (src - x0).astype(np.float32)


def interpolate_bilinear_np(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Host numpy twin of :func:`interpolate_bilinear_nhwc` (same taps) for
    (..., H, W) arrays: per-image mask resizing, where a device round trip
    costs more than the resample."""
    h, w = int(size[0]), int(size[1])
    x = np.asarray(x, dtype=np.float32)
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    y0, y1, fy = _linear_taps(x.shape[-2], h)
    x0, x1, fx = _linear_taps(x.shape[-1], w)
    t = x[..., y0, :] * (1.0 - fy)[:, None] + x[..., y1, :] * fy[:, None]
    return t[..., x0] * (1.0 - fx) + t[..., x1] * fx
