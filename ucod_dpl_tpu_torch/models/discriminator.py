"""Adversarial mask discriminator in PyTorch.

Counterpart of :mod:`ucod_dpl_tpu.models.discriminator` (the reference
``Discriminator``, ``models/discriminator.py:73-95``): ConvBlock(mask 1->32,
3x3 s1) [+ optional feature branch], two stride-2 ConvBlocks halving
channels, flatten, Linear -> sigmoid.  Every ConvBlock is a bias-free 3x3
convolution, batch norm and leaky ReLU(0.1).

Batch norm always normalises with the current batch's biased moments (the
reference only calls the discriminator in train mode); in a data-parallel
run of more than one process those of the global batch, all-reduced over
the ranks.  Trainable parameters
and the BN running statistics are separate dicts, so an optimizer never
touches the running moments; those follow torch's train-mode update
(momentum 0.1, unbiased variance) and are kept for checkpoints.

PyTorch layouts: convolution kernels OIHW, the linear weight ``(1, flat)``
over the NCHW flatten, so the weights map 1:1 onto reference checkpoints
(:mod:`.convert` maps the JAX package's HWIO / ``(flat, 1)`` trees).  The
public functions take NHWC masks and features, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.parallel.distributed import all_reduce_sum, group_size

_LEAKY_SLOPE = 0.1
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def _init_conv_block(rng: np.random.Generator, c_in: int, c_out: int):
    """torch Conv2d kaiming-uniform(a=sqrt(5)) 3x3 kernel, unit BN affine."""
    bound = np.sqrt(6.0 / ((1 + 5.0) * c_in * 9))
    params = {
        "conv_w": torch.from_numpy(rng.uniform(-bound, bound, (c_out, c_in, 3, 3)).astype(np.float32)),
        "bn_scale": torch.ones(c_out),
        "bn_bias": torch.zeros(c_out),
    }
    return params, {"mean": torch.zeros(c_out), "var": torch.ones(c_out)}


def init_discriminator(
    seed: int, feature_size: int = 68, feature_dim: int = 768, use_features: bool = False
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, stats) from ``numpy.random.default_rng(seed)`` with the JAX
    ``init_discriminator`` distributions, on the CPU."""
    rng = np.random.default_rng(seed)
    indim = (feature_dim if use_features else 0) + 32
    outdim = indim // 2
    mask_p, mask_s = _init_conv_block(rng, 1, 32)
    c0_p, c0_s = _init_conv_block(rng, indim, outdim)
    c1_p, c1_s = _init_conv_block(rng, indim // 2, outdim // 2)
    params: Dict[str, Any] = {"mask_conv": mask_p, "convs": [c0_p, c1_p]}
    stats: Dict[str, Any] = {"mask_conv": mask_s, "convs": [c0_s, c1_s]}
    if use_features:
        params["feature_conv"], stats["feature_conv"] = _init_conv_block(rng, feature_dim, feature_dim)
    flat = (outdim // 2) * ((feature_size + 3) // 4) ** 2
    bound = 1.0 / np.sqrt(flat)
    params["linear_w"] = torch.from_numpy(rng.uniform(-bound, bound, (1, flat)).astype(np.float32))
    params["linear_b"] = torch.from_numpy(rng.uniform(-bound, bound, (1,)).astype(np.float32))
    return params, stats


def _local_moments(y: torch.Tensor):
    """Per-channel (mean, biased variance, n / (n - 1)) over this batch's
    (N, H, W)."""
    mean = y.mean(dim=(0, 2, 3))
    var = ((y - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    n = y.shape[0] * y.shape[2] * y.shape[3]
    return mean, var, n / max(n - 1, 1)


def _global_moments(y: torch.Tensor, group=None):
    """The same over the global batch of a data-parallel run: the sums and
    counts of every rank of ``group`` (the default group when None; the
    ``data`` replica set under sequence parallelism, whose ``seq`` ranks hold
    the same rows) all-reduced (one all-reduce for the mean and the count,
    one for the two-pass variance), the gradient flowing back through both,
    as batch-statistics BN over the whole batch under GSPMD gives it in the
    JAX package."""
    c = y.shape[1]
    count = y.new_full((1,), float(y.shape[0] * y.shape[2] * y.shape[3]))
    sums = all_reduce_sum(torch.cat([y.sum(dim=(0, 2, 3)), count]), group)
    n = sums[c:].detach()
    mean = sums[:c] / n
    var = all_reduce_sum(((y - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3)), group) / n
    return mean, var, n / (n - 1).clamp(min=1)


def _conv_block(
    params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor], x: torch.Tensor, stride: int, group=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """NCHW conv + batch-statistics BN (over the ranks of ``group``) + leaky
    ReLU, and the refreshed running statistics."""
    y = F.conv2d(x, params["conv_w"], stride=stride, padding=1)
    # one process (a group of one too) keeps the local formula, whose bits
    # the one-process runs and their bitwise resume tests pin
    mean, var, unbiased_factor = _global_moments(y, group) if group_size(group) > 1 else _local_moments(y)
    y = (y - mean[:, None, None]) * torch.rsqrt(var + _BN_EPS)[:, None, None]
    y = y * params["bn_scale"][:, None, None] + params["bn_bias"][:, None, None]
    y = torch.where(y >= 0, y, _LEAKY_SLOPE * y)
    unbiased = var.detach() * unbiased_factor
    new_stats = {
        "mean": (1 - _BN_MOMENTUM) * stats["mean"] + _BN_MOMENTUM * mean.detach(),
        "var": (1 - _BN_MOMENTUM) * stats["var"] + _BN_MOMENTUM * unbiased,
    }
    return y, new_stats


def discriminator_forward(
    params: Dict[str, Any],
    stats: Dict[str, Any],
    mask: torch.Tensor,
    features: Optional[torch.Tensor] = None,
    group=None,
):
    """Score masks as real/fake.

    Args:
      params/stats: dicts from :func:`init_discriminator`.
      mask: (B, H, W, 1) mask (NHWC).
      features: (B, H, W, feature_dim), read only when the feature branch
        exists.
      group: the process group whose ranks' rows make the batch of the
        batch-norm moments (the default group when None).

    Returns ((B, 1) sigmoid probabilities, refreshed stats dict).
    """
    x, mc_s = _conv_block(params["mask_conv"], stats["mask_conv"], mask.permute(0, 3, 1, 2), stride=1, group=group)
    new_stats: Dict[str, Any] = {"mask_conv": mc_s, "convs": []}
    if "feature_conv" in params:
        f, fc_s = _conv_block(params["feature_conv"], stats["feature_conv"],
                              features.permute(0, 3, 1, 2), stride=1, group=group)
        new_stats["feature_conv"] = fc_s
        x = torch.cat([x, f], dim=1)
    for blk_p, blk_s in zip(params["convs"], stats["convs"]):
        x, nb_s = _conv_block(blk_p, blk_s, x, stride=2, group=group)
        new_stats["convs"].append(nb_s)
    logits = F.linear(x.reshape(x.shape[0], -1), params["linear_w"], params["linear_b"])
    return torch.sigmoid(logits), new_stats
