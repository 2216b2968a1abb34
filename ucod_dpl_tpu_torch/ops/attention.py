"""Multi-head attention for the DINO ViT on the packed (B, L, D) layout.

Counterpart of :mod:`ucod_dpl_tpu.ops.attention`.  Wrappers of hand-written
Hopper kernels, each with its plain PyTorch version beside it:

* :func:`packed_attention` (K1, ``csrc/attention_fwd.cu``, the port of the
  TPU kernel ``_attention_kernel_headpair``): the inference forward, for any
  head count of a head dim in :data:`HEADS_DIMS`.  Its plain version
  :func:`packed_attention_reference` mirrors the JAX ``_xla_attention``
  numerics: f32 scores and softmax, probabilities rounded to the input
  dtype, f32-accumulated ``p @ v`` rounded to the input dtype.
* :func:`packed_attention_fwd_lse` (the same kernel with an f32 log-sum-exp
  output, the port of K2 ``_attention_kernel_headpair_stats``): the forward
  of the differentiated path, at the head dims of :data:`BACKWARD_HEAD_DIMS`.
* :func:`packed_attention_bwd` (``csrc/attention_bwd.cu``, the port of K3
  ``_attention_bwd_kernel_headpair`` and K4 ``_bwd2d_dq_kernel`` +
  ``_bwd2d_dkv_kernel``): the flash backward from the saved log-sum-exp, at
  head dims 64 and 128 (the TPU kernels take every head dim of an even
  count with ``2 * d % 128 == 0``; the ViTs have 64, a tensor-parallel or
  wider model 128).

* :func:`attention_outproj_residual` (K12, ``csrc/attn_outproj.cu``, the
  port of the TPU prototype ``scripts/microbench/bench_attn_outproj.py::
  fused``): the forward, the out-projection, its bias, the layerscale and
  the residual add in one kernel, the attention output kept on chip.  Its
  plain version :func:`attention_outproj_residual_reference` follows the
  prototype's roundings.  A timing tool and a ``chip_smoke.py`` phase call
  it; no product path does.

:func:`packed_attention_diff` ties the last two together as a
``torch.autograd.Function`` (the JAX ``_packed_attention_diff`` custom VJP);
a forward that autograd does not record runs K1, as the JAX primal does.
:func:`differentiable_attention` is the routing of the JAX
``multi_head_attention`` under ``differentiable_mode``.

:func:`heads_attention` (K5, the port of ``_attention_kernel``) is the same
forward kernel on the per-head (B*H, L, d) layout, which the JAX dispatch
splits odd head counts to (its packed kernel pairs heads into the TPU's 128
lanes).  On the card :func:`multi_head_attention` needs no split: the
forward reads any head count in place.  :func:`tp_multi_head_attention`
runs it per tensor-parallel shard.

Dispatch is by device alone: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ucod_dpl_tpu_torch.ops import _build

_LOG2E = math.log2(math.e)
BACKWARD_HEAD_DIMS = (64, 128)  # the head dims of the forward with log-sum-exp (K2) and of the backward
HEADS_DIMS = (16, 32, 64, 128)  # the head dims of the forward (K1, K5)


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


def _check_kernel_inputs(q, num_heads, head_dims=BACKWARD_HEAD_DIMS, what="packed_attention", **others):
    """Raise unless ``q`` and every tensor of ``others`` (by name) is what the
    attention kernels take: bf16, contiguous, 16-byte aligned, q's shape and
    device, (B, L, num_heads * d) with d in ``head_dims``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, x in (("q", q), *others.items()):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous inputs; {name} is not")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(x.shape)}@{x.device} "
                             f"differs from q {tuple(q.shape)}@{q.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs 16-byte aligned {name}")
    if q.dim() != 3 or num_heads < 1 or q.shape[-1] % num_heads or q.shape[-1] // num_heads not in head_dims:
        raise ValueError(f"{what} kernel needs (B, L, num_heads * d) with d in {head_dims}; got "
                         f"{tuple(q.shape)} with {num_heads} heads")
    if q.shape[1] < 1 or q.shape[0] * num_heads > 65535:
        raise ValueError(f"{what} kernel: unsupported shape {tuple(q.shape)}")


def _launch_forward(q, k, v, o, num_heads: int, scale: float) -> None:
    """The forward kernel on checked (B, L, num_heads * d) tensors."""
    b, l, dm = q.shape
    with torch.cuda.device(q.device):
        err = _build.kernels().ucod_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, num_heads, dm // num_heads,
            float(scale) * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_cuda(err, "attention_fwd")


def packed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, L, num_heads * d) bf16 q/k/v, d in :data:`HEADS_DIMS`, any head
    count -> attention output, same layout, written into ``out`` when given.

    CUDA tensors launch the forward kernel (counted in
    ``packed_attention.launches``); CPU tensors take
    :func:`packed_attention_reference`."""
    if q.device.type == "cpu":
        o = packed_attention_reference(q, k, v, num_heads, scale)
        return o if out is None else out.copy_(o)
    o = torch.empty_like(q) if out is None else out
    _check_kernel_inputs(q, num_heads, HEADS_DIMS, k=k, v=v, out=o)
    _launch_forward(q, k, v, o, num_heads, scale)
    packed_attention.launches += 1
    return o


packed_attention.launches = 0


def attention_outproj_residual_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    x: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    ls: torch.Tensor,
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version of :func:`attention_outproj_residual`, with the roundings
    of the TPU prototype ``bench_attn_outproj.py::_kernel`` in q's dtype:
    ``q * scale`` rounded; per head f32 scores and ``p = exp(s - max)``, ``p``
    rounded before its f32 product with v and the sum of the unrounded ``p``
    as the denominator; each head's output rounded; its product with the
    (out, in) weight ``wo`` (rounded) summed over heads in f32; then ``x + (.
    + bo) * ls`` in f32 and one rounding.  Every key takes part: the
    prototype's padded tail (NaN where it is not finite) has no counterpart."""
    dtype = q.dtype
    s = torch.matmul(_heads((q.float() * scale).to(dtype), num_heads), _heads(k, num_heads).transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(dtype).float(), _heads(v, num_heads)) / p.sum(dim=-1, keepdim=True)
    y = torch.matmul(_merge_heads(o, dtype).float(), wo.to(dtype).float().t()) + bo.float().reshape(-1)
    return (x.float() + y * ls.float().reshape(-1)).to(dtype)


def attention_outproj_residual(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    x: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    ls: torch.Tensor,
    num_heads: int,
    scale: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x + (attention(q, k, v) wo^T + bo) * ls``: (B, L, D) bf16 q/k/v and
    residual ``x``, ``wo`` the (D, D) out-projection in (out, in) layout, ``bo``
    and ``ls`` its bias and the layerscale, (D,) -> (B, L, D), written into
    ``out`` when given.

    CUDA tensors launch K12 (counted in
    ``attention_outproj_residual.launches``): bf16 q/k/v/x/wo, f32 bo and
    ls, head dim 64, an even head count, D a multiple of 256 and at most
    768; CPU tensors take :func:`attention_outproj_residual_reference`."""
    if q.device.type == "cpu":
        ref = attention_outproj_residual_reference(q, k, v, x, wo, bo, ls, num_heads, scale)
        return ref if out is None else out.copy_(ref)
    what = "attention_outproj_residual"
    out = torch.empty_like(q) if out is None else out
    _check_kernel_inputs(q, num_heads, (64,), what, k=k, v=v, x=x, out=out)
    b, l, d = q.shape
    if num_heads % 2 or d % 256 or d > 768:
        raise ValueError(f"{what} kernel needs an even head count and D % 256 == 0, D <= 768; got "
                         f"{num_heads} heads, D {d}")
    if wo.dtype != torch.bfloat16 or wo.shape != (d, d) or wo.device != q.device or not wo.is_contiguous() \
            or wo.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs a contiguous 16-byte aligned bf16 ({d}, {d}) wo on {q.device}; "
                         f"got {wo.dtype} {tuple(wo.shape)}@{wo.device}")
    for name, t in (("bo", bo), ("ls", ls)):
        if t.dtype != torch.float32 or t.numel() != d or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 8:
            raise ValueError(f"{what} kernel needs a contiguous f32 {name} of {d} values on {q.device}; got "
                             f"{t.dtype} {tuple(t.shape)}@{t.device}")
    with torch.cuda.device(q.device):
        err = _build.kernels().ucod_attention_outproj(
            *(t.data_ptr() for t in (q, k, v, x, wo, bo, ls, out)), b, l, num_heads, float(scale) * _LOG2E,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_cuda(err, "attention_outproj")
    attention_outproj_residual.launches += 1
    return out


attention_outproj_residual.launches = 0


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, nh * hd) -> (B, nh, L, hd) in float32."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2).float()


def _merge_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, nh, L, hd) -> (B, L, nh * hd) in ``dtype``."""
    b, nh, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, nh * hd).to(dtype)


def _kv_len(kv_len: Optional[int], l: int) -> int:
    """The key bound of the forward with log-sum-exp and the backward: the
    keys ``[0, kv_len)`` of a length-``l`` tensor take part, the rest get
    probability 0 (a sequence-parallel ring's chunk that ends in padding);
    None means all ``l``."""
    if kv_len is None:
        return l
    if not 1 <= int(kv_len) <= l:
        raise ValueError(f"attention kv_len must be in [1, {l}]; got {kv_len} (a ring skips a chunk with no key)")
    return int(kv_len)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, num_heads: int, scale: float, kv_len: int) -> torch.Tensor:
    """f32 (B, nh, L, L) scores ``scale q.k``, -inf at keys >= ``kv_len``."""
    s = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2)) * scale
    if kv_len < s.shape[-1]:
        s = s.masked_fill(torch.arange(s.shape[-1], device=s.device) >= kv_len, float("-inf"))
    return s


def packed_attention_fwd_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: float,
    kv_len: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`packed_attention_fwd_lse`: the output of
    :func:`packed_attention_reference` over the keys ``[0, kv_len)`` (their
    scores masked before the softmax), rounded to ``out_dtype`` (default
    q's), and the f32 (B, num_heads, L) log-sum-exp ``ln sum_{j < kv_len}
    exp(scale q.k_j)`` of each query row."""
    kv_len = _kv_len(kv_len, q.shape[1])
    s = _masked_scores(q, k, num_heads, scale, kv_len)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = _merge_heads(torch.matmul(p.float(), _heads(v, num_heads)), out_dtype or q.dtype)
    return o, torch.logsumexp(s, dim=-1)


def packed_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    num_heads: int,
    scale: float,
    kv_len: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`packed_attention_bwd`: the f32 flash algebra of
    the JAX ``_xla_attention_packed_bwd`` with the probabilities recomputed
    from the saved log-sum-exp, ``P = exp(scale q k^T - lse)``, 0 at keys >=
    ``kv_len``; (dq, dk, dv) in ``out_dtype`` (default the dtype of
    q/k/v)."""
    qh, kh, vh, oh, doh = (_heads(x, num_heads) for x in (q, k, v, o, do))
    p = torch.exp(_masked_scores(q, k, num_heads, scale, _kv_len(kv_len, q.shape[1])) - lse.float()[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - torch.sum(doh * oh, dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    return (_merge_heads(dq, out_dtype or q.dtype), _merge_heads(dk, out_dtype or k.dtype),
            _merge_heads(dv, out_dtype or v.dtype))


def _check_outputs(what: str, q: torch.Tensor, dtype: torch.dtype, **outs) -> None:
    """Raise unless every tensor of ``outs`` is a contiguous, 16-byte aligned
    ``dtype`` (bf16 or f32) tensor of q's shape on q's device."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel writes bf16 or f32; asked for {dtype}")
    for name, x in outs.items():
        if x.dtype != dtype or x.shape != q.shape or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} {tuple(q.shape)}@{q.device}; got "
                             f"{x.dtype} {tuple(x.shape)}@{x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs 16-byte aligned {name}")


def _check_lse(lse: torch.Tensor, q: torch.Tensor, num_heads: int) -> None:
    b, l, _ = q.shape
    if lse.dtype != torch.float32 or lse.shape != (b, num_heads, l):
        raise ValueError(f"attention lse must be f32 ({b}, {num_heads}, {l}); got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"attention lse must be contiguous on {q.device}")


def packed_attention_fwd_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: float,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    kv_len: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, num_heads * d) bf16 q/k/v, d in :data:`BACKWARD_HEAD_DIMS` ->
    (attention output, f32 (B, num_heads, L) log-sum-exp), written into
    ``out = (o, lse)`` when given.

    ``kv_len`` (1..L, default L): only the keys ``[0, kv_len)`` take part;
    the rest get probability 0 and are not read.  ``out_dtype``: the
    output's dtype, q's (bf16) or float32 (a ring's partial outputs, merged
    before they are rounded).  CUDA tensors launch K1 with its log-sum-exp
    store (counted in ``packed_attention_fwd_lse.launches``); CPU tensors
    take :func:`packed_attention_fwd_lse_reference`."""
    kv_len = _kv_len(kv_len, q.shape[1])
    if q.device.type == "cpu":
        refs = packed_attention_fwd_lse_reference(q, k, v, num_heads, scale, kv_len, out_dtype)
        return refs if out is None else tuple(o.copy_(r) for o, r in zip(out, refs))
    b, l, _ = q.shape
    dtype = out_dtype or q.dtype
    if out is None:
        o = torch.empty(q.shape, device=q.device, dtype=dtype)
        lse = torch.empty(b, num_heads, l, device=q.device, dtype=torch.float32)
    else:
        o, lse = out
    _check_kernel_inputs(q, num_heads, k=k, v=v)
    _check_outputs("packed_attention_fwd_lse", q, dtype, out=o)
    _check_lse(lse, q, num_heads)
    with torch.cuda.device(q.device):
        err = _build.kernels().ucod_attention_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, l, kv_len,
            num_heads, q.shape[-1] // num_heads, float(scale) * _LOG2E, int(dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_cuda(err, "attention_fwd_lse")
    packed_attention_fwd_lse.launches += 1
    return o, lse


packed_attention_fwd_lse.launches = 0


def bwd_scratch(b: int, l: int, num_heads: int, device, head_dim: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's f32 scratch, per (batch * head, row) with the
    rows padded to a multiple of 64: {lse * log2 e, D} and dQ's sums
    (``head_dim`` a row), the latter followed by two int32 semaphores per
    (batch * head, 64-row q tile) that order the additions into dQ; all
    filled by the kernel's pre-pass."""
    padded = -(-l // 64) * 64
    return (torch.empty(b * num_heads * padded * 2, device=device, dtype=torch.float32),
            torch.empty(b * num_heads * padded * head_dim + b * num_heads * padded // 64 * 2, device=device,
                        dtype=torch.float32))


def packed_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    num_heads: int,
    scale: float,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    *,
    kv_len: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of packed attention from its inputs, output
    ``o``, output cotangent ``do`` and saved log-sum-exp, written into ``out``
    when given; (B, L, num_heads * d) like q, d in :data:`BACKWARD_HEAD_DIMS`,
    bf16 or ``out_dtype``
    (float32 for a ring's partial gradients, summed before they are
    rounded).

    ``kv_len`` (1..L, default L): the key bound of the forward that saved
    ``lse``; dk and dv rows past it come out as exact zeros.  CUDA tensors
    launch the statistics pre-pass, the one-pass backward and the dq cast of
    ``csrc/attention_bwd.cu`` (counted once per call in
    ``packed_attention_bwd.launches``); dq is summed in f32 by reduce-adds in
    a fixed order, so equal inputs give equal gradients bit for bit.  CPU
    tensors take :func:`packed_attention_bwd_reference`."""
    kv_len = _kv_len(kv_len, q.shape[1])
    if q.device.type == "cpu":
        refs = packed_attention_bwd_reference(q, k, v, o, do, lse, num_heads, scale, kv_len, out_dtype)
        return refs if out is None else tuple(t.copy_(r) for t, r in zip(out, refs))
    dtype = out_dtype or q.dtype
    grads = tuple(torch.empty(q.shape, device=q.device, dtype=dtype) for _ in range(3)) if out is None else tuple(out)
    _check_kernel_inputs(q, num_heads, k=k, v=v, o=o, do=do)
    _check_outputs("packed_attention_bwd", q, dtype, dq=grads[0], dk=grads[1], dv=grads[2])
    _check_lse(lse, q, num_heads)
    b, l, dm = q.shape
    stats, dq_acc = bwd_scratch(b, l, num_heads, q.device, dm // num_heads)
    with torch.cuda.device(q.device):
        err = _build.kernels().ucod_attention_bwd(
            *(x.data_ptr() for x in (q, k, v, o, do, lse, stats, dq_acc, *grads)), b, l, kv_len, num_heads,
            dm // num_heads, float(scale), int(dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check_cuda(err, "attention_bwd")
    packed_attention_bwd.launches += 1
    return grads


packed_attention_bwd.launches = 0


class PackedAttention(torch.autograd.Function):
    """Packed attention whose backward is the flash backward from the saved
    log-sum-exp (the JAX ``_packed_attention_diff`` custom VJP): forward by
    :func:`packed_attention_fwd_lse`, backward by :func:`packed_attention_bwd`.
    Gradients come back in the dtype of q/k/v."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        o, lse = packed_attention_fwd_lse(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = packed_attention_bwd(q, k, v, o, do.contiguous(), lse, ctx.num_heads, ctx.scale)
        return dq, dk, dv, None, None


def packed_attention_diff(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Differentiable packed attention through the forward-LSE and backward
    kernels on CUDA (their plain versions on the CPU).  When autograd records
    nothing (grad mode off, or no input requiring grad) nothing is saved for
    a backward, and the forward is :func:`packed_attention` (K1), as the JAX
    ``_packed_attention_diff``'s primal runs its plain kernel: the same
    output, with no log-sum-exp store."""
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return packed_attention(q, k, v, num_heads, scale)
    return PackedAttention.apply(q, k, v, num_heads, scale)


def differentiable_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float, *, plain: bool = False
) -> torch.Tensor:
    """Attention on the differentiated path, routed as the JAX
    ``multi_head_attention`` routes it under ``differentiable_mode``: the
    heads :func:`packed_layout_ok` takes through
    :func:`packed_attention_diff` (on the card: head dims 64 and 128, any
    other raises), the rest (odd counts, ``2 * hd % 128 != 0``), and
    everything when ``plain``, through the plain version under autograd."""
    if plain or not packed_layout_ok(num_heads, q.shape[-1] // num_heads):
        return multi_head_attention(q, k, v, num_heads, scale, plain=True)
    return packed_attention_diff(q, k, v, num_heads, scale)


def heads_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch ``softmax(q k^T * scale) v`` on the per-head (BH, L, d)
    layout, with the numerics of the JAX ``_xla_attention``: f32 scores and
    softmax, probabilities rounded to the input dtype, f32-accumulated
    ``p @ v`` rounded to the input dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def heads_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(BH, L, d) bf16 q/k/v, d in :data:`HEADS_DIMS` -> attention output,
    same layout, written into ``out`` when given.

    CUDA tensors launch the forward kernel of :func:`packed_attention`, the
    per-head layout read as a packed one of BH batch elements and one head
    (counted in ``heads_attention.launches``); CPU tensors take
    :func:`heads_attention_reference`."""
    if q.device.type == "cpu":
        o = heads_attention_reference(q, k, v, scale)
        return o if out is None else out.copy_(o)
    o = torch.empty_like(q) if out is None else out
    _check_kernel_inputs(q, 1, HEADS_DIMS, "heads_attention", k=k, v=v, out=o)
    _launch_forward(q, k, v, o, 1, scale)
    heads_attention.launches += 1
    return o


heads_attention.launches = 0


def packed_layout_ok(num_heads: int, head_dim: int) -> bool:
    """The JAX dispatch's rule for its packed kernels: an even head count
    with ``2 * hd % 128 == 0``.  The port's backward is built for the head
    dims of that set that a model has, :data:`BACKWARD_HEAD_DIMS`."""
    return num_heads % 2 == 0 and (2 * head_dim) % 128 == 0


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float, *, plain: bool = False
) -> torch.Tensor:
    """(B, L, D) q/k/v projections -> (B, L, D) attention output.

    On the card every head count of a head dim in :data:`HEADS_DIMS` runs
    the forward kernel on the packed layout (:func:`packed_attention`, which
    raises for other head dims), with no split or merge.  The JAX
    ``multi_head_attention`` sends the heads :func:`packed_layout_ok`
    refuses (odd counts, among them) to its per-head kernel (K5) instead:
    the function is the same, only the layout differs.  CPU tensors and
    ``plain`` take the plain versions of the JAX dispatch's routes:
    :func:`packed_attention_reference` for an even head count of 64, else a
    split to (B * H, L, hd), :func:`heads_attention_reference` and a merge."""
    b, l, d = q.shape
    hd = d // num_heads
    if not plain and q.device.type != "cpu":
        return packed_attention(q, k, v, num_heads, scale)
    if packed_layout_ok(num_heads, hd) and hd == 64:
        return packed_attention_reference(q, k, v, num_heads, scale)

    def split(x):
        return x.reshape(b, l, num_heads, hd).transpose(1, 2).reshape(b * num_heads, l, hd)

    o = heads_attention_reference(split(q), split(k), split(v), scale)
    return o.reshape(b, num_heads, l, hd).transpose(1, 2).reshape(b, l, d)


def tp_multi_head_attention(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    num_heads: int,
    *,
    scale: float,
    mesh,
    axis: str = "model",
    plain: bool = False,
    differentiable: bool = False,
) -> List[torch.Tensor]:
    """Tensor-parallel attention, the counterpart of the JAX
    ``tp_multi_head_attention``: the heads are split over ``axis`` of
    ``mesh``, and a sharded (B, L, D) tensor is the list of its shards, shard
    ``m`` holding columns ``[m * D / tp, (m + 1) * D / tp)`` on its device.
    Attention is head-local, so each shard runs :func:`multi_head_attention`
    (:func:`differentiable_attention` when ``differentiable``) on its
    ``num_heads / tp`` heads with no communication; returns the output
    shards.  On a mesh whose ``axis`` spans processes the lists hold this
    process's shards (:meth:`~ucod_dpl_tpu_torch.parallel.mesh.Mesh.local_block`)."""
    tp = mesh.shape[axis]
    if num_heads % tp:
        raise ValueError(f"{num_heads} heads not divisible by {axis}={tp}")
    held = len(mesh.local_block()[axis])
    if not len(qs) == len(ks) == len(vs) == held:
        raise ValueError(f"tp_multi_head_attention needs this process's {held} shards of q/k/v over {axis}={tp}; "
                         f"got {len(qs)}, {len(ks)}, {len(vs)}")
    if differentiable:
        return [differentiable_attention(q, k, v, num_heads // tp, scale, plain=plain) for q, k, v in zip(qs, ks, vs)]
    return [multi_head_attention(q, k, v, num_heads // tp, scale, plain=plain) for q, k, v in zip(qs, ks, vs)]
