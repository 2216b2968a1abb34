"""Int8 (W8A8) quantized linears for the opt-in int8 serving path.

Counterpart of :mod:`ucod_dpl_tpu.ops.quant`, with the same scheme:
  * weights: per-output-channel symmetric scales, computed once
    (:func:`quantize_linear`), ``max|w| / 127`` over each output row;
  * activations: per-token symmetric dynamic scales (:func:`quantize_act`),
    ``max|x| / 127`` over each row;
  * an exact int32 product, rescaled in float32 as ``acc * (s_x * w_s) + b``
    and cast to the caller's dtype.

Rounding is ``torch.round`` (half to even, as ``jnp.round``), after a true
division by the scale (never a multiply by its reciprocal: that flips ties).
The scale itself is ``max * (1 / 127)`` in float32: what the JAX package
computes for ``max / 127.0`` under ``jax.jit`` (XLA turns the division by a
constant into that multiply), and what PyTorch on CUDA computes for a
division by a Python scalar; written out, it is the same on every device and
in the kernels.

A quantized linear is ``{"w_q": int8 (out, in), "w_s": f32 (out,), "b": f32
(out,)}``: the JAX package's ``(in, out)`` weight transposed, so the scale is
a max over dim 1.  The int8 weight is K-contiguous, the B operand the int8
tensor-core products want (``models.convert.quant_from_jax`` carries JAX
trees across).  The product of :func:`dense_w8a8_pre` is ``torch._int_mm``
(cuBLASLt's int8 GEMM on the card): the JAX package leaves it to XLA outside
any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-12
_INV_127 = 1.0 / 127.0  # a multiplier; float32 after the cast, as in the kernels
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA needs more than 16 rows

QParams = Dict[str, torch.Tensor]


def quantize_linear(p: Dict[str, torch.Tensor]) -> QParams:
    """``{"w": (out, in), "b": (out,)}`` -> int8 weight with per-output-channel
    symmetric scales; the bias stays float32 (it adds after the rescale)."""
    w = p["w"].float()
    s = torch.clamp_min(w.abs().amax(dim=1) * _INV_127, _EPS)
    w_q = torch.clamp(torch.round(w / s[:, None]), -127.0, 127.0).to(torch.int8)
    return {"w_q": w_q, "w_s": s, "b": p["b"].float()}


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization -> ``(x_q int8, s_x f32 (..., 1))``."""
    xf = x.float()
    s_x = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) * _INV_127, _EPS)
    x_q = torch.clamp(torch.round(xf / s_x), -127.0, 127.0).to(torch.int8)
    return x_q, s_x


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 times (N, K) int8, transposed -> (..., N) int32, exact."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    a = x_q.reshape(-1, k).contiguous()
    m = a.shape[0]
    if a.device.type == "cuda" and m < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    # w_q.t() is the column-major (K, N) operand of cuBLASLt's "TN" int8 GEMM
    return torch._int_mm(a, w_q.t())[:m].reshape(*lead, w_q.shape[0])


def dense_w8a8_pre(x_q: torch.Tensor, s_x: torch.Tensor, qp: QParams, out_dtype: torch.dtype) -> torch.Tensor:
    """The product half of :func:`dense_w8a8` on activations already
    quantized by :func:`quantize_act`."""
    acc = int8_matmul(x_q, qp["w_q"])
    return (acc.float() * (s_x * qp["w_s"]) + qp["b"]).to(out_dtype)


def dense_w8a8(x: torch.Tensor, qp: QParams, out_dtype: torch.dtype) -> torch.Tensor:
    """``x W^T + b`` with int8 weights and per-token int8 activations."""
    x_q, s_x = quantize_act(x)
    return dense_w8a8_pre(x_q, s_x, qp, out_dtype)


_VIT_LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def quantize_dino_linears(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every transformer-layer linear of a DINO params tree
    (``models/dino.py`` layout).  Norms, layerscales, patch embed, position
    embeddings and the CLS token are not quantized: the forward reads them
    from the params tree.  Quantize the float32 weights, not a bf16 copy:
    the codes and scales would differ."""
    return {"layers": [{name: quantize_linear(layer[name]) for name in _VIT_LINEARS}
                       for layer in params["layers"]]}
