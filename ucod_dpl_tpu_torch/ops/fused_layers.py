"""LayerNorm, dense and the fused LayerNorm + q/k/v projections.

Counterpart of :mod:`ucod_dpl_tpu.ops.fused_layers` (and of the
``_layernorm``/``_dense`` helpers of ``ucod_dpl_tpu.models.dino``).
:func:`layernorm_qkv` wraps the hand-written Hopper kernel K6
(``csrc/layernorm_qkv.cu``, the port of the TPU kernel ``_lnqkv_kernel``);
:func:`layernorm_qkv_reference` is its plain PyTorch version.  K7,
LayerNorm + fc1 + GELU, is another instantiation of K6's main kernel (same
source), and the int8 (W8A8) kernels K8-K11 are in ``csrc/int8_linear.cu``;
each has a wrapper of the JAX package's name below and a ``*_reference``
plain version.

Parameters use PyTorch layouts: a linear is ``{"w": (out, in), "b": (out,)}``
and a norm ``{"scale": (d,), "bias": (d,)}``, all float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops import _build, quant

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
    if d % 256 or d > 1024:  # 256-wide column tiles; gamma/beta of every column in shared memory
        raise ValueError(f"layernorm_qkv kernel needs hidden % 256 == 0 and <= 1024; got {d}")
    if not 1 <= x.numel() // d <= 2**31 - 1:
        raise ValueError(f"layernorm_qkv kernel: unsupported row count {x.numel() // d}")
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

    CUDA tensors launch K6, its statistics pre-pass and its main kernel
    (counted once in ``layernorm_qkv.launches``), with f32 (mean, rstd)
    scratch of 8 bytes a row; CPU tensors take
    :func:`layernorm_qkv_reference`.  Weights held in bf16 and norm/bias
    vectors in float32 (``models.dino.cast_params``) are passed without a
    cast."""
    if x.device.type == "cpu":
        refs = layernorm_qkv_reference(x, norm, q, k, v, eps)
        return refs if out is None else tuple(o.copy_(r) for o, r in zip(out, refs))
    ws = [p["w"].to(torch.bfloat16).contiguous() for p in (q, k, v)]
    vecs = [t.float().contiguous() for t in (norm["scale"], norm["bias"], q["b"], k["b"], v["b"])]
    outs = [torch.empty_like(x) for _ in range(3)] if out is None else list(out)
    _check_kernel_inputs(x, ws, vecs, outs)
    d = x.shape[-1]
    rows = x.numel() // d
    stats = torch.empty(rows, 2, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _build.kernels().ucod_layernorm_qkv(
            *(t.data_ptr() for t in [x, vecs[0], vecs[1], *ws, *vecs[2:], *outs, stats]),
            rows, d, float(eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check_cuda(err, "layernorm_qkv")
    layernorm_qkv.launches += 1
    return tuple(outs)


layernorm_qkv.launches = 0


# ---------------------------------------------------------------------------
# int8 (W8A8) kernels K8-K11 (csrc/int8_linear.cu).  Their plain versions
# follow the TPU kernels, not the JAX fallback: the normalised h stays float32
# (the fallback's ``_layernorm`` rounds it to the compute dtype first; on
# float32 inputs the two agree).  Quantized linears use the ops/quant.py
# layout: {"w_q": int8 (out, in), "w_s": f32 (out,), "b": f32 (out,)}.
# ---------------------------------------------------------------------------

def _kernel_row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of the kernels' warp reduction, so
    the LayerNorm statistics of kernel and plain version agree bit for bit:
    lane l of 32 holds the 8 values 256 j + 8 l .. + 7 of each 256-wide
    chunk j (the row zero-padded to whole chunks), sums them as a pairwise
    tree, adds the chunks in order, and the lanes combine by an xor
    butterfly (each step adds two lanes' sums, which is commutative)."""
    pad = -v.shape[-1] % 256
    t = F.pad(v, (0, pad)).unflatten(-1, (-1, 32, 8))
    for _ in range(3):
        t = t[..., 0::2] + t[..., 1::2]
    t = t[..., 0]
    acc = t[..., 0, :]
    for j in range(1, t.shape[-2]):
        acc = acc + t[..., j, :]
    lanes = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return acc[..., :1]


def _layernorm_f32(x: torch.Tensor, norm: Params, eps: float) -> torch.Tensor:
    """The kernels' LayerNorm: f32 statistics summed in their order
    (:func:`_kernel_row_sum`) and scaled by ``1 / d`` (as XLA computes a mean
    under jit), ``1 / sqrt`` correctly rounded, f32 result."""
    xf = x.float()
    inv_d = 1.0 / xf.shape[-1]
    mean = _kernel_row_sum(xf) * inv_d
    c = xf - mean
    var = _kernel_row_sum(c * c) * inv_d
    return c * torch.reciprocal(torch.sqrt(var + eps)) * norm["scale"].float() + norm["bias"].float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in float32, written as JAX does."""
    return x * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * (x * x * x)))))


def layernorm_qkv_w8a8_reference(x, norm: Params, q8_q, q8_k, q8_v, eps: float):
    """LN, one shared per-token quantization, three int8 products."""
    h_q, h_s = quant.quantize_act(_layernorm_f32(x, norm, eps))
    return tuple(quant.dense_w8a8_pre(h_q, h_s, qp, x.dtype) for qp in (q8_q, q8_k, q8_v))


def layernorm_fc1_gelu_w8a8_reference(x, norm: Params, q8_fc1, eps: float):
    """LN, quantize, int8 fc1, tanh GELU in f32, requantize -> (codes, scales)."""
    h_q, h_s = quant.quantize_act(_layernorm_f32(x, norm, eps))
    return quant.quantize_act(gelu_tanh(quant.dense_w8a8_pre(h_q, h_s, q8_fc1, torch.float32)))


def dense_quant_w8a8_reference(x, qp, out_dtype: torch.dtype):
    """Per-token quantization of ``x`` and one int8 product (``dense_w8a8``)."""
    return quant.dense_w8a8(x, qp, out_dtype)


def layernorm_mlp_w8a8_reference(x, norm: Params, q8_fc1, q8_fc2, eps: float):
    """The whole int8 MLP half: K9's plain version, then the int8 fc2."""
    g_q, g_s = layernorm_fc1_gelu_w8a8_reference(x, norm, q8_fc1, eps)
    return quant.dense_w8a8_pre(g_q, g_s, q8_fc2, x.dtype)


def _check_int8_inputs(what: str, x: torch.Tensor, vecs, mats, outs) -> None:
    """``mats``: (tensor, shape) of int8 weights; ``vecs``: (tensor, shape)
    of f32 vectors; ``outs``: (tensor, shape, dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    d = x.shape[-1]
    if d % 256 or d > 1024:  # 8 values a lane, 32 lanes a row, at most 4 times
        raise ValueError(f"{what} kernel needs hidden % 256 == 0 and <= 1024; got {d}")
    if x.numel() // d > 2**31 - 1:
        raise ValueError(f"{what} kernel: too many rows ({x.numel() // d})")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 activations; got {x.dtype}")
    for group, dtype in ((mats, torch.int8), (vecs, torch.float32)):
        for t, shape in group:
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(f"{what} kernel needs {dtype} {tuple(shape)}; got {t.dtype} {tuple(t.shape)}")
    for t, shape, dtype in outs:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: out must be {dtype} {tuple(shape)}; got {t.dtype} {tuple(t.shape)}")
    for t in [x, *(m for m, _ in mats), *(v for v, _ in vecs), *(o for o, _, _ in outs)]:
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs contiguous, 16-byte aligned tensors on {x.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _quant_scratch(x: torch.Tensor):
    """The quantize pre-pass's scratch of K8-K11: int8 codes (rows, D) and
    f32 scales (rows,) of the (normalised) rows of ``x``."""
    d = x.shape[-1]
    rows = x.numel() // d
    return (torch.empty((rows, d), dtype=torch.int8, device=x.device),
            torch.empty((rows,), dtype=torch.float32, device=x.device))


def _launch(what: str, fn, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_cuda(err, what)


def layernorm_qkv_w8a8(x, norm: Params, q8_q, q8_k, q8_v, eps: float, out=None):
    """(..., D) hidden state -> int8 (q, k, v) projections of its LayerNorm,
    in ``x.dtype``, written into the three tensors of ``out`` when given.

    CUDA tensors launch K8, its quantize pre-pass and main kernel (counted
    once in ``layernorm_qkv_w8a8.launches``), with the pre-pass's scratch
    (:func:`_quant_scratch`); CPU tensors take
    :func:`layernorm_qkv_w8a8_reference`."""
    if x.device.type == "cpu":
        refs = layernorm_qkv_w8a8_reference(x, norm, q8_q, q8_k, q8_v, eps)
        return refs if out is None else tuple(o.copy_(r) for o, r in zip(out, refs))
    d = x.shape[-1]
    qps = (q8_q, q8_k, q8_v)
    ln = [_f32(norm["scale"]), _f32(norm["bias"])]
    ws = [qp["w_q"].contiguous() for qp in qps]
    scales = [_f32(qp["w_s"]) for qp in qps]
    biases = [_f32(qp["b"]) for qp in qps]
    outs = [torch.empty_like(x) for _ in range(3)] if out is None else list(out)
    _check_int8_inputs("layernorm_qkv_w8a8", x, [(t, (d,)) for t in ln + scales + biases],
                       [(w, (d, d)) for w in ws], [(o, x.shape, x.dtype) for o in outs])
    scratch = _quant_scratch(x)
    _launch("layernorm_qkv_w8a8", _build.kernels().ucod_layernorm_qkv_w8a8, x,
            *(t.data_ptr() for t in [x, *ln, *ws, *scales, *biases, *outs, *scratch]), x.numel() // d, d, float(eps))
    layernorm_qkv_w8a8.launches += 1
    return tuple(outs)


layernorm_qkv_w8a8.launches = 0


def dense_quant_w8a8(x, qp, out_dtype: torch.dtype, out=None):
    """Per-token int8 quantization of ``x`` (..., K) and one int8 linear ->
    (..., N) in ``out_dtype``: the attention out-projection of the int8 path.

    CUDA tensors launch K10, its quantize pre-pass and main kernel (counted
    once in ``dense_quant_w8a8.launches``; it takes ``out_dtype == x.dtype ==
    bf16``); CPU tensors take
    :func:`dense_quant_w8a8_reference`."""
    if x.device.type == "cpu":
        ref = dense_quant_w8a8_reference(x, qp, out_dtype)
        return ref if out is None else out.copy_(ref)
    k = x.shape[-1]
    n = qp["w_q"].shape[0]
    if out_dtype != x.dtype:
        raise TypeError(f"dense_quant_w8a8 kernel writes x.dtype; got out_dtype {out_dtype}, x {x.dtype}")
    if n % 256:
        raise ValueError(f"dense_quant_w8a8 kernel needs out features % 256 == 0; got {n}")
    w, scale, bias = qp["w_q"].contiguous(), _f32(qp["w_s"]), _f32(qp["b"])
    out_shape = (*x.shape[:-1], n)
    res = torch.empty(out_shape, dtype=x.dtype, device=x.device) if out is None else out
    _check_int8_inputs("dense_quant_w8a8", x, [(scale, (n,)), (bias, (n,))], [(w, (n, k))],
                       [(res, out_shape, x.dtype)])
    scratch = _quant_scratch(x)
    _launch("dense_quant_w8a8", _build.kernels().ucod_quant_dense_w8a8, x,
            *(t.data_ptr() for t in (x, w, scale, bias, res, *scratch)), x.numel() // k, k, n)
    dense_quant_w8a8.launches += 1
    return res


dense_quant_w8a8.launches = 0


# K9 and K11 split an expansion of F columns over the 16 consumer warpgroups
# of a cluster of 8 CTAs (csrc/int8_linear.cu, kColumnParts); each runs wgmma
# at a width their main kernel is built for.
K9_COLUMN_PARTS = 16
K9_WIDTHS = (64, 96, 128, 192)


def k9_width(f: int) -> int:
    """The columns each of K9's (and K11's) consumer warpgroups owns for an
    expansion of ``f``: ``f / 16``; raises for an ``f`` whose share is not a
    width the kernel is built for (F = 1024, 1536, 2048 and 3072 are)."""
    if f % K9_COLUMN_PARTS or f // K9_COLUMN_PARTS not in K9_WIDTHS:
        raise ValueError(f"layernorm_fc1_gelu_w8a8 kernel needs an expansion of {K9_COLUMN_PARTS} x one of "
                         f"{K9_WIDTHS}; got {f}")
    return f // K9_COLUMN_PARTS


def _mlp_inputs(x, norm, q8_fc1, q8_fc2=None):
    d = x.shape[-1]
    f = q8_fc1["w_q"].shape[0]
    vecs = [(_f32(norm["scale"]), (d,)), (_f32(norm["bias"]), (d,)),
            (_f32(q8_fc1["w_s"]), (f,)), (_f32(q8_fc1["b"]), (f,))]
    mats = [(q8_fc1["w_q"].contiguous(), (f, d))]
    if q8_fc2 is not None:
        vecs += [(_f32(q8_fc2["w_s"]), (d,)), (_f32(q8_fc2["b"]), (d,))]
        mats.append((q8_fc2["w_q"].contiguous(), (d, f)))
    return d, f, vecs, mats


def layernorm_fc1_gelu_w8a8(x, norm: Params, q8_fc1, eps: float, out=None):
    """(..., D) -> the int8 codes (..., F) of ``gelu(fc1_w8a8(LN(x)))`` and
    their per-token scales (..., 1) f32, ready for ``quant.dense_w8a8_pre``
    (fc2); written into ``out = (codes, scales)`` when given.

    CUDA tensors launch K9, its quantize pre-pass and main kernel (counted
    once in ``layernorm_fc1_gelu_w8a8.launches``; the expansion as
    :func:`k9_width` takes it); CPU tensors take
    :func:`layernorm_fc1_gelu_w8a8_reference`."""
    if x.device.type == "cpu":
        refs = layernorm_fc1_gelu_w8a8_reference(x, norm, q8_fc1, eps)
        return refs if out is None else tuple(o.copy_(r) for o, r in zip(out, refs))
    d, f, vecs, mats = _mlp_inputs(x, norm, q8_fc1)
    k9_width(f)
    lead = x.shape[:-1]
    if out is None:
        out = (torch.empty((*lead, f), dtype=torch.int8, device=x.device),
               torch.empty((*lead, 1), dtype=torch.float32, device=x.device))
    _check_int8_inputs("layernorm_fc1_gelu_w8a8", x, vecs, mats,
                       [(out[0], (*lead, f), torch.int8), (out[1], (*lead, 1), torch.float32)])
    gamma, beta, w1s, b1 = (v for v, _ in vecs)
    w1 = mats[0][0]
    scratch = _quant_scratch(x)
    _launch("layernorm_fc1_gelu_w8a8", _build.kernels().ucod_layernorm_fc1_gelu_w8a8, x,
            *(t.data_ptr() for t in (x, gamma, beta, w1, w1s, b1, *out, *scratch)), x.numel() // d, d, f, float(eps))
    layernorm_fc1_gelu_w8a8.launches += 1
    return tuple(out)


layernorm_fc1_gelu_w8a8.launches = 0


def layernorm_mlp_w8a8(x, norm: Params, q8_fc1, q8_fc2, eps: float, out=None):
    """(..., D) -> the whole int8 MLP half ``fc2_w8a8(requant(gelu(
    fc1_w8a8(quant(LN(x))))))`` in ``x.dtype``, the hidden expansion kept on
    chip; written into ``out`` when given.

    CUDA tensors launch K11, its quantize pre-pass and main kernel (counted
    once in ``layernorm_mlp_w8a8.launches``; the shapes K9 takes, the
    expansion as :func:`k9_width` takes it), with the pre-pass's scratch
    (:func:`_quant_scratch`); CPU tensors take
    :func:`layernorm_mlp_w8a8_reference`."""
    if x.device.type == "cpu":
        ref = layernorm_mlp_w8a8_reference(x, norm, q8_fc1, q8_fc2, eps)
        return ref if out is None else out.copy_(ref)
    d, f, vecs, mats = _mlp_inputs(x, norm, q8_fc1, q8_fc2)
    k9_width(f)
    res = torch.empty_like(x) if out is None else out
    _check_int8_inputs("layernorm_mlp_w8a8", x, vecs, mats, [(res, x.shape, x.dtype)])
    gamma, beta, w1s, b1, w2s, b2 = (v for v, _ in vecs)
    w1, w2 = (m for m, _ in mats)
    scratch = _quant_scratch(x)
    _launch("layernorm_mlp_w8a8", _build.kernels().ucod_layernorm_mlp_w8a8, x,
            *(t.data_ptr() for t in (x, gamma, beta, w1, w1s, b1, w2, w2s, b2, res, *scratch)), x.numel() // d, d,
            f, float(eps))
    layernorm_mlp_w8a8.launches += 1
    return res


layernorm_mlp_w8a8.launches = 0


# ---------------------------------------------------------------------------
# LayerNorm + fc1 + tanh GELU, bf16 (K7: K6's main kernel with one weight and
# a GELU epilogue, csrc/layernorm_qkv.cu): the op the JAX package exports as
# ``layernorm_fc1_gelu``.  No forward calls it, as no forward of the JAX
# package does (its ViT composes LN, dense and GELU).
# ---------------------------------------------------------------------------

def layernorm_fc1_gelu_reference(x: torch.Tensor, norm: Params, fc1: Params, eps: float) -> torch.Tensor:
    """K7's arithmetic (the TPU kernel's, ``_lnfc1_kernel``) in plain PyTorch:
    LayerNorm statistics in f32 (:func:`_layernorm_f32`), h rounded to
    ``x.dtype``; fc1 with f32 accumulation plus the f32 bias, rounded to
    ``x.dtype``; tanh GELU computed in f32 from that value and rounded to
    ``x.dtype``."""
    h = _layernorm_f32(x, norm, eps).to(x.dtype)
    h1 = (F.linear(h.float(), fc1["w"].float()) + fc1["b"].float()).to(x.dtype)
    return gelu_tanh(h1.float()).to(x.dtype)


def layernorm_fc1_gelu(x: torch.Tensor, norm: Params, fc1: Params, eps: float,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., D) hidden state -> ``gelu_tanh(fc1(LN(x)))`` (..., F) in
    ``x.dtype``, written into ``out`` when given.

    CUDA tensors launch K7, K6's statistics pre-pass and main kernel (counted
    once in ``layernorm_fc1_gelu.launches``; it takes bf16 activations with D
    % 64 == 0, D <= 1024 and F % 256 == 0), with f32 (mean, rstd) scratch of 8
    bytes a row; CPU tensors take :func:`layernorm_fc1_gelu_reference`."""
    if x.device.type == "cpu":
        ref = layernorm_fc1_gelu_reference(x, norm, fc1, eps)
        return ref if out is None else out.copy_(ref)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_fc1_gelu: unsupported device {x.device}")
    d = x.shape[-1]
    f = fc1["w"].shape[0]
    if d % 64 or d > 1024 or f % 256:
        raise ValueError(f"layernorm_fc1_gelu kernel needs hidden % 64 == 0, <= 1024 and an expansion "
                         f"% 256 == 0; got {d} -> {f}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"layernorm_fc1_gelu kernel takes bf16 activations; got {x.dtype}")
    if x.numel() // d > 2**31 - 1:
        raise ValueError(f"layernorm_fc1_gelu kernel: too many rows ({x.numel() // d})")
    w = fc1["w"].to(torch.bfloat16).contiguous()
    gamma, beta, b1 = _f32(norm["scale"]), _f32(norm["bias"]), _f32(fc1["b"])
    res = torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device) if out is None else out
    for t, shape, dtype in ((w, (f, d), torch.bfloat16), (gamma, (d,), torch.float32),
                            (beta, (d,), torch.float32), (b1, (f,), torch.float32),
                            (res, (*x.shape[:-1], f), torch.bfloat16)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"layernorm_fc1_gelu kernel needs {dtype} {tuple(shape)}; got {t.dtype} {tuple(t.shape)}")
    for t in (x, w, gamma, beta, b1, res):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layernorm_fc1_gelu kernel needs contiguous, 16-byte aligned tensors on {x.device}")
    stats = torch.empty(x.numel() // d, 2, device=x.device, dtype=torch.float32)
    _launch("layernorm_fc1_gelu", _build.kernels().ucod_layernorm_fc1_gelu, x,
            *(t.data_ptr() for t in (x, gamma, beta, w, b1, res, stats)), x.numel() // d, d, f, float(eps))
    layernorm_fc1_gelu.launches += 1
    return res


layernorm_fc1_gelu.launches = 0
