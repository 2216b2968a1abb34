"""Multi-head attention for the DINO ViT on the packed (B, L, D) layout.

Counterpart of :mod:`ucod_dpl_tpu.ops.attention`.  :func:`packed_attention`
wraps the hand-written Hopper kernel K1 (``csrc/attention_fwd.cu``, the
port of the TPU kernel ``_attention_kernel_headpair``); its plain PyTorch
version :func:`packed_attention_reference` mirrors the JAX ``_xla_attention``
numerics: f32 scores and softmax, probabilities rounded to the input dtype,
f32-accumulated ``p @ v`` rounded to the input dtype.

Dispatch is by device alone: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ucod_dpl_tpu_torch.ops import _build

_LOG2E = math.log2(math.e)
HEAD_DIM = 64


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain PyTorch ``softmax(q k^T * scale) v`` per head on (B, L, D)."""
    b, l, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, l, num_heads, hd).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(p.float(), heads(v)).to(q.dtype)
    return o.transpose(1, 2).reshape(b, l, d)


def _check_kernel_inputs(q, k, v, o, num_heads):
    if q.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", o)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"packed_attention kernel takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"packed_attention kernel takes contiguous inputs; {name} is not")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"packed_attention: {name} {tuple(x.shape)}@{x.device} "
                             f"differs from q {tuple(q.shape)}@{q.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"packed_attention kernel needs 16-byte aligned {name}")
    if q.dim() != 3 or q.shape[-1] != num_heads * HEAD_DIM:
        raise ValueError(
            f"packed_attention kernel needs (B, L, num_heads * {HEAD_DIM}); got "
            f"{tuple(q.shape)} with {num_heads} heads"
        )
    if q.shape[1] < 1 or q.shape[0] * num_heads > 65535:
        raise ValueError(f"packed_attention kernel: unsupported shape {tuple(q.shape)}")


def packed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, L, num_heads * 64) bf16 q/k/v -> attention output, same layout,
    written into ``out`` when given.

    CUDA tensors launch K1 (counted in ``packed_attention.launches``); CPU
    tensors take :func:`packed_attention_reference`."""
    if q.device.type == "cpu":
        o = packed_attention_reference(q, k, v, num_heads, scale)
        return o if out is None else out.copy_(o)
    o = torch.empty_like(q) if out is None else out
    _check_kernel_inputs(q, k, v, o, num_heads)
    b, l, _ = q.shape
    with torch.cuda.device(q.device):
        err = _build.kernels().ucod_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, num_heads,
            float(scale) * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_cuda(err, "attention_fwd")
    packed_attention.launches += 1
    return o


packed_attention.launches = 0
