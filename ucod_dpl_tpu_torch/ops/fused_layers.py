"""LayerNorm, dense and the fused LayerNorm + q/k/v projections.

Counterpart of :mod:`ucod_dpl_tpu.ops.fused_layers` (and of the
``_layernorm``/``_dense`` helpers of ``ucod_dpl_tpu.models.dino``).
:func:`layernorm_qkv` wraps the hand-written Hopper kernel K6
(``csrc/layernorm_qkv.cu``, the port of the TPU kernel ``_lnqkv_kernel``);
:func:`layernorm_qkv_reference` is its plain PyTorch version.

Parameters use PyTorch layouts: a linear is ``{"w": (out, in), "b": (out,)}``
and a norm ``{"scale": (d,), "bias": (d,)}``, all float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops import _build

Params = Dict[str, torch.Tensor]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in ``x.dtype``."""
    d = x.shape[-1]
    return F.layer_norm(x.float(), (d,), p["scale"].float(), p["bias"].float(), eps).to(x.dtype)


def dense(x: torch.Tensor, p: Params, dtype: torch.dtype) -> torch.Tensor:
    """``x W^T + b`` in ``dtype``: the product is rounded to ``dtype`` before
    the bias is added, as the JAX ``_dense`` does in bf16."""
    return F.linear(x, p["w"].to(dtype)) + p["b"].to(dtype)


def layernorm_qkv_reference(
    x: torch.Tensor, norm: Params, q: Params, k: Params, v: Params, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch LN followed by the three projections."""
    h = layer_norm(x, norm, eps)
    return dense(h, q, x.dtype), dense(h, k, x.dtype), dense(h, v, x.dtype)


def _check_kernel_inputs(x: torch.Tensor, weights, vecs, outs) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_qkv: unsupported device {x.device}")
    d = x.shape[-1]
    if d % 256 or d > 1024:  # 256-wide column tiles; rows + weight stages fit shared memory
        raise ValueError(f"layernorm_qkv kernel needs hidden % 256 == 0 and <= 1024; got {d}")
    if x.numel() // d > 2**31 - 1:
        raise ValueError(f"layernorm_qkv kernel: too many rows ({x.numel() // d})")
    for w in weights:
        if w.shape != (d, d):
            raise ValueError(f"layernorm_qkv kernel needs ({d}, {d}) weights; got {tuple(w.shape)}")
    for vec in vecs:
        if vec.shape != (d,):
            raise ValueError(f"layernorm_qkv kernel needs ({d},) norm/bias vectors; got {tuple(vec.shape)}")
    for o in outs:
        if o.shape != x.shape:
            raise ValueError(f"layernorm_qkv: out {tuple(o.shape)} differs from x {tuple(x.shape)}")
    for t in [x, *weights, *outs]:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"layernorm_qkv kernel takes bf16 activations and weights; got {t.dtype}")
    for t in [x, *weights, *vecs, *outs]:
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layernorm_qkv kernel needs contiguous, 16-byte aligned tensors on {x.device}")


def layernorm_qkv(
    x: torch.Tensor,
    norm: Params,
    q: Params,
    k: Params,
    v: Params,
    eps: float,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., D) hidden state -> (q, k, v) projections of its LayerNorm,
    written into the three tensors of ``out`` when given.

    CUDA tensors launch K6 (counted in ``layernorm_qkv.launches``); CPU
    tensors take :func:`layernorm_qkv_reference`.  Weights held in bf16 and
    norm/bias vectors in float32 (``models.dino.cast_params``) are passed
    without a cast."""
    if x.device.type == "cpu":
        refs = layernorm_qkv_reference(x, norm, q, k, v, eps)
        return refs if out is None else tuple(o.copy_(r) for o, r in zip(out, refs))
    ws = [p["w"].to(torch.bfloat16).contiguous() for p in (q, k, v)]
    vecs = [t.float().contiguous() for t in (norm["scale"], norm["bias"], q["b"], k["b"], v["b"])]
    outs = [torch.empty_like(x) for _ in range(3)] if out is None else list(out)
    _check_kernel_inputs(x, ws, vecs, outs)
    d = x.shape[-1]
    with torch.cuda.device(x.device):
        err = _build.kernels().ucod_layernorm_qkv(
            *(t.data_ptr() for t in [x, vecs[0], vecs[1], *ws, *vecs[2:], *outs]),
            x.numel() // d, d, float(eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check_cuda(err, "layernorm_qkv")
    layernorm_qkv.launches += 1
    return tuple(outs)


layernorm_qkv.launches = 0
