"""Sequence-parallel (ring) attention over a mesh axis, in one process.

Counterpart of :mod:`ucod_dpl_tpu.parallel.sp`.  Sequence parallelism
splits the token dimension, the one that grows with resolution (1370 tokens
at 518px, 2917 at 756px, 5477 at 1036px), into ``n`` chunks, one per device
of the ``seq`` axis.  A sequence-sharded (B, L, D) tensor is the list of its
chunks, chunk ``i`` holding tokens ``[i * L / n, (i + 1) * L / n)`` on its
device.  Everything in a ViT block but attention is token-local and runs on
each chunk's own device; attention is the ring below.

Where the JAX ring rotates k/v chunks with ``ppermute`` and merges them into
an f32 online-softmax accumulator, here each (query chunk i, key/value
chunk j) pair is one call of the forward with log-sum-exp (the port of K2,
:func:`~ucod_dpl_tpu_torch.ops.attention.packed_attention_fwd_lse`) on
query chunk i's device, with an f32 output.  The partial outputs are merged
by their log-sum-exps in f32 and rounded once::

    lse_i = logsumexp_j lse_ij,   o_i = sum_j exp(lse_ij - lse_i) o_ij,

which is JAX's online softmax regrouped.  The backward
(:class:`RingAttention`) runs one flash backward (the port of K3/K4,
:func:`~ucod_dpl_tpu_torch.ops.attention.packed_attention_bwd`) per pair
from the global o_i and lse_i, with f32 outputs: dQ_i summed over j on
chunk i's device, dK_j and dV_j over i on chunk j's device, each rounded
once, as the JAX ``_local_ring_bwd`` accumulates them.  The pairs run in a
fixed order (i, then j), so equal inputs give equal outputs and gradients
bit for bit.

Padding: ViT lengths are 1 + grid**2 (2917 at 756px is prime), so the
tokens are padded at the end to ``padded_len(L, n)``, a multiple of n, as
JAX pads them.  Chunk j then holds ``kv_lens[j]`` real keys (the first
tokens hold the data, only the last chunks padding); the kernels take that
count as their key bound, so padded keys add exactly nothing, and a chunk
with no real key is never launched.  Padded query rows give finite values
that the caller slices off.

2D (SP x TP): attention is head-local, so with a head axis each tensor-
parallel shard rings its own heads over the ``seq`` chunks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ucod_dpl_tpu_torch.ops.attention import (
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_fwd_lse,
    packed_attention_fwd_lse_reference,
)
from ucod_dpl_tpu_torch.parallel.mesh import Mesh
from ucod_dpl_tpu_torch.parallel.tp import place_shard


def padded_len(seq_len: int, n: int) -> int:
    """``seq_len`` rounded up to a multiple of the ring size ``n``."""
    return -(-seq_len // n) * n


def chunk_kv_lens(seq_len: int, n: int) -> List[int]:
    """The real (unpadded) tokens of each of the ``n`` chunks of a length
    ``seq_len`` padded at the end to :func:`padded_len`; 0 for a chunk of
    padding only."""
    c = padded_len(seq_len, n) // n
    return [max(0, min(c, seq_len - i * c)) for i in range(n)]


def split_tokens(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """(B, L, D) -> its ``len(devices)`` token chunks, padded with zeros at
    the end to :func:`padded_len`, chunk i on ``devices[i]``."""
    n = len(devices)
    pad = padded_len(x.shape[1], n) - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], dim=1)
    return [c.to(d) for c, d in zip(x.chunk(n, dim=1), devices)]


def gather_tokens(chunks: Sequence[torch.Tensor], seq_len: int, device: torch.device) -> torch.Tensor:
    """The chunks concatenated on ``device``, the padding sliced off."""
    return torch.cat([c.to(device) for c in chunks], dim=1)[:, :seq_len]


def _merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], num_heads: int, dtype: torch.dtype):
    """(f32 o_ij (B, c, H * d), lse_ij (B, H, c)) of one query chunk, in j
    order -> (o_i rounded to ``dtype``, lse_i): the log-sum-exp merge in f32."""
    if len(parts) == 1:
        o, lse = parts[0]
        return o.to(dtype), lse
    lse = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    b, c, dm = parts[0][0].shape
    acc = None
    for o, lse_j in parts:
        w = torch.exp(lse_j - lse).transpose(1, 2).unsqueeze(-1)  # (B, c, H, 1)
        term = o.view(b, c, num_heads, dm // num_heads) * w
        acc = term if acc is None else acc + term
    return acc.reshape(b, c, dm).to(dtype), lse


def _ring_forward(qs, ks, vs, num_heads: int, scale: float, kv_lens, plain: bool):
    """The forward ring: per query chunk, one forward with log-sum-exp per
    chunk with a real key, merged -> (outputs, global log-sum-exps)."""
    fwd = packed_attention_fwd_lse_reference if plain else packed_attention_fwd_lse
    valid = [j for j, n_j in enumerate(kv_lens) if n_j > 0]
    if len(valid) == 1 and len(qs) == 1:
        # no ring: one masked call, rounded by the kernel
        o, lse = fwd(qs[0], ks[0], vs[0], num_heads, scale, kv_len=kv_lens[0])
        return [o], [lse]
    outs, lses = [], []
    for q in qs:
        parts = [fwd(q, ks[j].to(q.device), vs[j].to(q.device), num_heads, scale, kv_len=kv_lens[j],
                     out_dtype=torch.float32) for j in valid]
        o, lse = _merge(parts, num_heads, q.dtype)
        outs.append(o)
        lses.append(lse)
    return outs, lses


class RingAttention(torch.autograd.Function):
    """Ring attention whose backward is a ring of flash backwards from the
    saved global output and log-sum-exp (the JAX ring's custom VJP).
    ``apply(meta, *q_chunks, *k_chunks, *v_chunks)`` with ``meta = (num_heads,
    scale, kv_lens, plain)`` -> the output chunks."""

    @staticmethod
    def forward(ctx, meta, *chunks):
        num_heads, scale, kv_lens, plain = meta
        n = len(kv_lens)
        qs, ks, vs = chunks[:n], chunks[n:2 * n], chunks[2 * n:]
        outs, lses = _ring_forward(qs, ks, vs, num_heads, scale, kv_lens, plain)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.meta = meta
        return tuple(outs)

    @staticmethod
    def backward(ctx, *d_outs):
        num_heads, scale, kv_lens, plain = ctx.meta
        n = len(kv_lens)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        bwd = packed_attention_bwd_reference if plain else packed_attention_bwd
        f32 = torch.float32
        dk = [torch.zeros(k.shape, device=k.device, dtype=f32) for k in ks]
        dv = [torch.zeros(v.shape, device=v.device, dtype=f32) for v in vs]
        dq = []
        for i, q in enumerate(qs):
            do = torch.zeros_like(outs[i]) if d_outs[i] is None else d_outs[i].contiguous()
            dq_i = None
            for j, n_j in enumerate(kv_lens):
                if n_j == 0:
                    continue
                g = bwd(q, ks[j].to(q.device), vs[j].to(q.device), outs[i], do, lses[i], num_heads, scale,
                        kv_len=n_j, out_dtype=f32)
                dq_i = g[0] if dq_i is None else dq_i + g[0]
                dk[j] += g[1].to(dk[j].device)
                dv[j] += g[2].to(dv[j].device)
            dq.append(dq_i.to(q.dtype))
        return (None, *dq, *(g.to(k.dtype) for g, k in zip(dk, ks)), *(g.to(v.dtype) for g, v in zip(dv, vs)))


def _ring(qs, ks, vs, num_heads: int, scale: float, kv_lens, plain: bool) -> List[torch.Tensor]:
    """One head group's ring; through :class:`RingAttention` when autograd
    records."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*qs, *ks, *vs)):
        return list(RingAttention.apply((num_heads, float(scale), tuple(kv_lens), plain), *qs, *ks, *vs))
    return _ring_forward(qs, ks, vs, num_heads, scale, kv_lens, plain)[0]


def ring_attention(
    qs: Sequence[Any],
    ks: Sequence[Any],
    vs: Sequence[Any],
    num_heads: int,
    *,
    scale: float,
    kv_lens: Sequence[int],
    mesh: Mesh,
    axis: str = "seq",
    h_axis: Optional[str] = None,
    plain: bool = False,
) -> List[Any]:
    """Sequence-parallel attention over ``axis`` of ``mesh`` (the JAX
    ``ring_attention``): ``qs``/``ks``/``vs`` are the token chunks of q/k/v,
    (B, L / n, num_heads * d) each on its chunk's device, ``kv_lens[j]`` the
    real tokens of chunk j (:func:`chunk_kv_lens`).  Returns the output
    chunks; differentiable through :class:`RingAttention` when autograd
    records.  CPU tensors and ``plain`` take the kernels' plain versions.

    ``h_axis``: the 2D (SP x TP) case.  Each of ``qs``/``ks``/``vs`` is then
    the list over the ``h_axis`` shards (``num_heads / size`` heads each) of
    their token chunks, and each shard rings its own heads; returns
    ``[shard][chunk]``."""
    n = mesh.shape[axis]
    if h_axis is not None and mesh.shape.get(h_axis, 1) == 1:
        h_axis = None
    if h_axis is not None:
        if h_axis == axis:
            raise ValueError(f"h_axis={h_axis!r} must differ from the ring axis {axis!r}")
        tp = mesh.shape[h_axis]
        if num_heads % tp:
            raise ValueError(f"{num_heads} heads not divisible by mesh axis {h_axis}={tp}")
        if not len(qs) == len(ks) == len(vs) == tp:
            raise ValueError(f"ring_attention over {h_axis}={tp} needs {tp} head shards; got {len(qs)}")
        return [ring_attention(q, k, v, num_heads // tp, scale=scale, kv_lens=kv_lens, mesh=mesh, axis=axis,
                               plain=plain) for q, k, v in zip(qs, ks, vs)]
    if not len(qs) == len(ks) == len(vs) == len(kv_lens) == n:
        raise ValueError(f"ring_attention over {axis}={n} needs {n} chunks of q/k/v and kv_lens; got "
                         f"{len(qs)}, {len(ks)}, {len(vs)}, {len(kv_lens)}")
    if kv_lens[0] < 1:
        raise ValueError("ring_attention: the first chunk holds no real token")
    # the kernels take contiguous chunks (a view of a (B, L, D) tensor split
    # along L is not, for B > 1)
    qs, ks, vs = ([x.contiguous() for x in xs] for xs in (qs, ks, vs))
    return _ring(qs, ks, vs, num_heads, scale, kv_lens, plain)


def sp_param_grid(params, mesh: Mesh, axis: str = "seq", tp_axis: Optional[str] = None,
                  data: int = 0) -> List[List[Dict[str, Any]]]:
    """``params`` placed for the sequence-parallel forward at ``data``
    coordinate ``data`` of ``mesh``: ``grid[i][m]`` is the parameter dict (of
    ``tp_axis`` shard ``m``, the whole ViT without one) on the device at
    ``axis`` coordinate ``i`` and ``tp_axis`` coordinate ``m``.  Each distinct
    (shard, device) is placed once and shared (one card named several
    times holds one copy of each shard).  The copies are differentiable:
    a forward of LoRA-merged weights places them at each call."""
    tp = mesh.shape[tp_axis] if tp_axis is not None else 1
    placed: Dict[Any, Dict[str, Any]] = {}
    grid = []
    for i in range(mesh.shape[axis]):
        row = []
        for m in range(tp):
            coords = {axis: i, **({tp_axis: m} if tp_axis is not None else {})}
            if "data" in mesh.shape:
                coords["data"] = data
            device = mesh.device(**coords)
            if (m, device) not in placed:
                placed[(m, device)] = place_shard(params, m, tp, device)
            row.append(placed[(m, device)])
        grid.append(row)
    return grid
