"""Sequence-parallel (ring) attention over a mesh axis, in one process or
across processes.

Counterpart of :mod:`ucod_dpl_tpu.parallel.sp`.  Sequence parallelism
splits the token dimension, the one that grows with resolution (1370 tokens
at 518px, 2917 at 756px, 5477 at 1036px), into ``n`` chunks, one per device
of the ``seq`` axis.  A sequence-sharded (B, L, D) tensor is the list of its
chunks, chunk ``i`` holding tokens ``[i * L / n, (i + 1) * L / n)`` on its
device.  Everything in a ViT block but attention is token-local and runs on
each chunk's own device; attention is the ring below.

The ring follows the JAX ``_local_ring``: at hop ``t`` query chunk ``i``
meets key/value chunk ``(i - t) mod n``, then every k/v chunk moves one
step along the ring (position ``i`` to ``i + 1``).  A step between two
chunks of this process is a device copy; a step to or from another
process's chunk is a send/recv (:func:`~ucod_dpl_tpu_torch.parallel.
distributed.ring_exchange`: NCCL on the card, gloo on the CPU).  A process
holds consecutive chunks of the ring (a mesh of one process holds all of
them), so each hop it sends at most one chunk and receives at most one.

Where the JAX ring merges every hop into an f32 online-softmax accumulator,
here each (query chunk i, key/value chunk j) pair is one call of the
forward with log-sum-exp (the port of K2,
:func:`~ucod_dpl_tpu_torch.ops.attention.packed_attention_fwd_lse`) on
query chunk i's device, with an f32 output.  The partial outputs are kept
and merged by their log-sum-exps in f32, in chunk order ``j`` whatever the
hop that brought them, and rounded once::

    lse_i = logsumexp_j lse_ij,   o_i = sum_j exp(lse_ij - lse_i) o_ij,

which is JAX's online softmax regrouped.  The backward
(:class:`RingAttention`, the JAX ``_local_ring_bwd``) runs one flash
backward (the port of K3/K4,
:func:`~ucod_dpl_tpu_torch.ops.attention.packed_attention_bwd`) per pair
from the global o_i and lse_i, with f32 outputs, in the same hop order:
dQ_i sums on chunk i's device, and the f32 dK_j and dV_j accumulators ride
the ring with their k/v chunk and are home after n hops; each is rounded
once.  The order of every sum is fixed by the ring, not by where a chunk
lives, so both transports give equal outputs and gradients bit for bit.

Padding: ViT lengths are 1 + grid**2 (2917 at 756px is prime), so the
tokens are padded at the end to ``padded_len(L, n)``, a multiple of n, as
JAX pads them.  Chunk j then holds ``kv_lens[j]`` real keys (the first
tokens hold the data, only the last chunks padding); the kernels take that
count as their key bound, so padded keys add exactly nothing, and a pair
whose key chunk has no real key launches no kernel (its tensors still move
on, or the ring would stall).  Padded query rows give finite values that the
caller slices off.

2D (SP x TP): attention is head-local, so with a head axis each tensor-
parallel shard rings its own heads over the ``seq`` chunks.  The shards a
process holds ring together, in one :class:`RingAttention` whose hops move
every shard's k/v chunks in one exchange, so that the backward's exchanges
run in one autograd node, in one order on every process.  The head axis may
lie inside each process or across processes (a process then holds its own
head shards only).
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
from ucod_dpl_tpu_torch.parallel import distributed as D
from ucod_dpl_tpu_torch.parallel.mesh import Mesh
from ucod_dpl_tpu_torch.parallel.tp import place_grid


def padded_len(seq_len: int, n: int) -> int:
    """``seq_len`` rounded up to a multiple of the ring size ``n``."""
    return -(-seq_len // n) * n


def chunk_kv_lens(seq_len: int, n: int) -> List[int]:
    """The real (unpadded) tokens of each of the ``n`` chunks of a length
    ``seq_len`` padded at the end to :func:`padded_len`; 0 for a chunk of
    padding only."""
    c = padded_len(seq_len, n) // n
    return [max(0, min(c, seq_len - i * c)) for i in range(n)]


def split_tokens(x: torch.Tensor, devices: Sequence[torch.device], n: Optional[int] = None,
                 positions: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """(B, L, D) -> its ``n`` token chunks (``len(devices)`` by default),
    padded with zeros at the end to :func:`padded_len`; the chunks at
    ``positions`` (all by default), chunk ``positions[a]`` on
    ``devices[a]``."""
    n = len(devices) if n is None else n
    positions = range(n) if positions is None else positions
    pad = padded_len(x.shape[1], n) - x.shape[1]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], dim=1)
    chunks = x.chunk(n, dim=1)
    return [chunks[i].to(d) for i, d in zip(positions, devices, strict=True)]


def gather_tokens(chunks: Sequence[torch.Tensor], seq_len: int, device: torch.device,
                  group=D.LOCAL) -> torch.Tensor:
    """The chunks concatenated on ``device``, those of the other processes of
    ``group`` (:meth:`Mesh.group` of the ring's axis) gathered after them in
    rank order (differentiable: the backward keeps this process's slice),
    the padding sliced off."""
    x = torch.cat([c.to(device) for c in chunks], dim=1)
    return D.all_gather_tokens(x, group)[:, :seq_len]


class Ring:
    """This process's part of the ring over ``axis`` of ``mesh``: ``n``
    positions, of which it holds ``positions`` (consecutive), the global
    ranks of the processes before and after them (None when the ring closes
    in this process) and the ring's subgroup."""

    def __init__(self, mesh: Mesh, axis: str = "seq"):
        self.n = mesh.shape[axis]
        block = mesh.local_block()
        self.positions = block[axis]
        self.prev_rank = self.next_rank = None
        self.group = mesh.group(axis)
        if len(self.positions) < self.n:
            first = {a: v[0] for a, v in block.items()}
            self.prev_rank = mesh.owner(**{**first, axis: (self.positions[0] - 1) % self.n})
            self.next_rank = mesh.owner(**{**first, axis: (self.positions[-1] + 1) % self.n})

    def shift(self, tensors: Sequence[Sequence[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """One step along the ring for each list of ``tensors`` (one tensor
        per held position): position i's tensor goes to position i + 1, by a
        device copy inside the process, else sent to the next process, while
        the first position receives from the previous one.  On the card the
        transfers go through the device of the first list's first position
        (this process's first card), whichever thread runs the shift (a
        backward runs in autograd's thread of a device)."""
        out = [[t[a - 1].to(t[a].device) for a in range(1, len(t))] for t in tensors]
        if self.next_rank is None:
            for o, t in zip(out, tensors):
                o.insert(0, t[-1].to(t[0].device))
            return out
        last = [t[-1] for t in tensors]
        via = tensors[0][0].device
        send = [x.to(via).contiguous() for x in last]
        recv = [torch.empty_like(x) for x in send]
        D.ring_exchange(send, recv, self.group, self.next_rank, self.prev_rank)
        for o, t, r in zip(out, tensors, recv):
            o.insert(0, r.to(t[0].device))
        return out


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


def _ring_forward(qs, ks, vs, num_heads: int, scale: float, kv_lens, plain: bool, ring: Ring):
    """The forward ring over this process's query chunks of each head group
    (``qs[g][a]``: group g, held position a): per hop one forward with
    log-sum-exp per pair with a real key, the k/v chunks of every group moved
    on together after each hop but the last; each query chunk's partials
    merged in chunk order -> (outputs, global log-sum-exps), ``[g][a]``."""
    fwd = packed_attention_fwd_lse_reference if plain else packed_attention_fwd_lse
    n, groups = ring.n, len(qs)
    if n == 1:
        # no ring: one masked call, rounded by the kernel
        res = [fwd(qs[g][0], ks[g][0], vs[g][0], num_heads, scale, kv_len=kv_lens[0]) for g in range(groups)]
        return [[o] for o, _ in res], [[lse] for _, lse in res]
    parts: List[List[Dict[int, Tuple[torch.Tensor, torch.Tensor]]]] = [[{} for _ in q] for q in qs]
    kv = [list(x) for x in (*ks, *vs)]  # group g's k at kv[g], its v at kv[groups + g]
    for t in range(n):
        for g in range(groups):
            for a, i in enumerate(ring.positions):
                j = (i - t) % n
                if kv_lens[j]:
                    parts[g][a][j] = fwd(qs[g][a], kv[g][a], kv[groups + g][a], num_heads, scale, kv_len=kv_lens[j],
                                         out_dtype=torch.float32)
        if t < n - 1:
            kv = ring.shift(kv)
    outs, lses = [], []
    for q_g, p_g in zip(qs, parts):
        merged = [_merge([p[j] for j in sorted(p)], num_heads, q.dtype) for q, p in zip(q_g, p_g)]
        outs.append([o for o, _ in merged])
        lses.append([lse for _, lse in merged])
    return outs, lses


def _split(flat, groups: int, m: int):
    """A flat sequence of ``groups * m`` tensors -> ``[g][a]``."""
    return [list(flat[g * m:(g + 1) * m]) for g in range(groups)]


class RingAttention(torch.autograd.Function):
    """Ring attention whose backward is a ring of flash backwards from the
    saved global output and log-sum-exp (the JAX ring's custom VJP).
    ``apply(meta, *q_chunks, *k_chunks, *v_chunks)`` over this process's
    chunks of every head group, each of q/k/v flattened group-major, with
    ``meta = (num_heads, scale, kv_lens, plain, ring, groups)`` -> the output
    chunks, flattened the same way."""

    @staticmethod
    def forward(ctx, meta, *chunks):
        num_heads, scale, kv_lens, plain, ring, groups = meta
        m = len(chunks) // (3 * groups)
        qs, ks, vs = (_split(chunks[i * groups * m:(i + 1) * groups * m], groups, m) for i in range(3))
        outs, lses = _ring_forward(qs, ks, vs, num_heads, scale, kv_lens, plain, ring)
        outs = [o for o_g in outs for o in o_g]
        ctx.save_for_backward(*chunks, *outs, *(x for l_g in lses for x in l_g))
        ctx.meta = meta
        return tuple(outs)

    @staticmethod
    def backward(ctx, *d_outs):
        num_heads, scale, kv_lens, plain, ring, groups = ctx.meta
        saved = ctx.saved_tensors
        gm = len(saved) // 5  # chunks of all groups
        qs, ks, vs, outs, lses = (saved[i * gm:(i + 1) * gm] for i in range(5))
        bwd = packed_attention_bwd_reference if plain else packed_attention_bwd
        f32 = torch.float32
        dos = [torch.zeros_like(o) if d is None else d.contiguous() for o, d in zip(outs, d_outs)]
        # k, v and their f32 dK/dV accumulators ride the ring together, every
        # group's in one exchange; flat index g * m + a: group g, position a
        m = gm // groups
        cur = [list(ks), list(vs), [torch.zeros(k.shape, device=k.device, dtype=f32) for k in ks],
               [torch.zeros(v.shape, device=v.device, dtype=f32) for v in vs]]
        dq: List[Optional[torch.Tensor]] = [None] * gm
        n = ring.n

        def per_group(lists):  # 4 flat lists -> 4 * groups lists of the held positions, for Ring.shift
            return [x[g * m:(g + 1) * m] for x in lists for g in range(groups)]

        def flat(lists):  # the inverse of per_group
            return [[t for g in range(groups) for t in lists[i * groups + g]] for i in range(len(lists) // groups)]

        for t in range(n):
            for g in range(groups):
                for a, i in enumerate(ring.positions):
                    j = (i - t) % n
                    if not kv_lens[j]:
                        continue
                    x = g * m + a
                    grads = bwd(qs[x], cur[0][x], cur[1][x], outs[x], dos[x], lses[x], num_heads, scale,
                                kv_len=kv_lens[j], out_dtype=f32)
                    dq[x] = grads[0] if dq[x] is None else dq[x] + grads[0]
                    cur[2][x] = cur[2][x] + grads[1]
                    cur[3][x] = cur[3][x] + grads[2]
            # after the last hop only the accumulators move, home
            cur = flat(ring.shift(per_group(cur))) if t < n - 1 else [None, None,
                                                                         *flat(ring.shift(per_group(cur[2:])))]
        return (None, *(g.to(q.dtype) for g, q in zip(dq, qs)), *(g.to(k.dtype) for g, k in zip(cur[2], ks)),
                *(g.to(v.dtype) for g, v in zip(cur[3], vs)))


def _ring(qs, ks, vs, num_heads: int, scale: float, kv_lens, plain: bool, ring: Ring) -> List[List[torch.Tensor]]:
    """The ring of this process's head groups (``qs[g][a]``) -> outputs
    ``[g][a]``; through :class:`RingAttention` when autograd records."""
    groups, m = len(qs), len(qs[0])
    chunks = [t for xs in (qs, ks, vs) for x_g in xs for t in x_g]
    if torch.is_grad_enabled() and any(t.requires_grad for t in chunks):
        outs = RingAttention.apply((num_heads, float(scale), tuple(kv_lens), plain, ring, groups), *chunks)
        return _split(outs, groups, m)
    return _ring_forward(qs, ks, vs, num_heads, scale, kv_lens, plain, ring)[0]


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
    ``ring_attention``): ``qs``/``ks``/``vs`` are this process's token chunks
    of q/k/v (all ``n`` on a mesh of one process; on a mesh over processes
    those of its block, :meth:`Mesh.local_block`), (B, L / n, num_heads * d)
    each on its chunk's device, ``kv_lens[j]`` the real tokens of chunk j of
    the whole ring (:func:`chunk_kv_lens`).  Returns the output chunks;
    differentiable through :class:`RingAttention` when autograd records.
    Every process of the ring must call it at the same point.  CPU tensors
    and ``plain`` take the kernels' plain versions.

    ``h_axis``: the 2D (SP x TP) case.  Each of ``qs``/``ks``/``vs`` is then
    the list over this process's ``h_axis`` shards (all of them when the
    axis stays in the process; ``num_heads / size`` heads each) of their
    token chunks, and each shard rings its own heads, all shards in one
    ring; returns ``[shard][chunk]``."""
    n = mesh.shape[axis]
    if h_axis is not None and mesh.shape.get(h_axis, 1) == 1:
        h_axis = None
    if h_axis is not None:
        if h_axis == axis:
            raise ValueError(f"h_axis={h_axis!r} must differ from the ring axis {axis!r}")
        tp = mesh.shape[h_axis]
        if num_heads % tp:
            raise ValueError(f"{num_heads} heads not divisible by mesh axis {h_axis}={tp}")
        held = len(mesh.local_block()[h_axis])
        if not len(qs) == len(ks) == len(vs) == held:
            raise ValueError(f"ring_attention over {h_axis}={tp} needs this process's {held} head shards; "
                             f"got {len(qs)}")
        num_heads //= tp
    else:
        qs, ks, vs = [qs], [ks], [vs]
    ring = Ring(mesh, axis)
    m = len(ring.positions)
    if any(not len(q) == len(k) == len(v) == m for q, k, v in zip(qs, ks, vs)) or len(kv_lens) != n:
        raise ValueError(f"ring_attention over {axis}={n} needs this process's {m} chunks of q/k/v and {n} kv_lens; "
                         f"got {[len(q) for q in qs]}, {[len(k) for k in ks]}, {[len(v) for v in vs]}, "
                         f"{len(kv_lens)}")
    if kv_lens[0] < 1:
        raise ValueError("ring_attention: the first chunk holds no real token")
    # the kernels take contiguous chunks (a view of a (B, L, D) tensor split
    # along L is not, for B > 1)
    qs, ks, vs = ([[x.contiguous() for x in x_g] for x_g in xs] for xs in (qs, ks, vs))
    outs = _ring(qs, ks, vs, num_heads, scale, kv_lens, plain, ring)
    return outs if h_axis is not None else outs[0]


def sp_param_grid(params, mesh: Mesh, axis: str = "seq", tp_axis: Optional[str] = None,
                  data: Optional[int] = None) -> List[List[Dict[str, Any]]]:
    """``params`` placed for the sequence-parallel forward at ``data``
    coordinate ``data`` of ``mesh`` (by default this process's first: 0 on a
    mesh of one process): ``grid[a][m]`` is the parameter dict (of
    ``tp_axis`` shard ``m``, the whole ViT without one) on the device at
    this process's ``a``-th ``axis`` coordinate and ``m``-th ``tp_axis``
    coordinate (every one on a mesh of one process; any other axis at this
    process's first coordinate).  Each distinct (shard,
    device) is placed once and shared (one card named several times holds
    one copy of each shard).  The copies are differentiable: a forward of
    LoRA-merged weights places them at each call, and a leaf read on several
    cards gets its copies' gradients summed in a fixed order
    (:func:`~ucod_dpl_tpu_torch.parallel.tp.place_grid`)."""
    tp = mesh.shape[tp_axis] if tp_axis is not None else 1
    block = mesh.local_block()
    if data is None:
        data = block["data"][0] if "data" in block else 0
    # the axes not named take this process's first coordinate (a model axis
    # without tp_axis: its replica)
    first = {a: v[0] for a, v in block.items()}
    rows = []
    for i in block[axis]:
        row = []
        for m in (block[tp_axis] if tp_axis is not None else range(1)):
            coords = {**first, axis: i, **({tp_axis: m} if tp_axis is not None else {})}
            if "data" in mesh.shape:
                coords["data"] = data
            row.append((m, mesh.device(**coords)))
        rows.append(row)
    return place_grid(params, rows, tp)
