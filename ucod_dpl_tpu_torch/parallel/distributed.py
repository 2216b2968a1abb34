"""Process groups over ``torch.distributed`` for data- and sequence-parallel
runs.

Counterpart of :mod:`ucod_dpl_tpu.parallel.distributed` (``jax.distributed``
over a TPU pod).  A launcher (``torchrun``, or anything that sets the same
``env://`` variables ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) starts one process per card;
:func:`maybe_initialize_distributed` then joins them in two groups:

* the default group carries the device collectives of training (the
  gradient all-reduce, :func:`all_reduce_mean_`, and the discriminator's
  batch-norm moments, :func:`all_reduce_sum`): NCCL for CUDA tensors
  (``"cpu:gloo,cuda:nccl"``) when the entry runs on the card, gloo on the
  CPU;
* a gloo group carries every host collective: the ragged metric gathers,
  the preemption flags, the batch counts and :func:`barrier`.  So an eval
  over two ranks that share one card never opens an NCCL communicator
  (NCCL refuses two ranks on one device).

A mesh over processes (:func:`~ucod_dpl_tpu_torch.parallel.mesh.build_mesh`
under a group) adds one subgroup per line of each mesh axis
(:func:`subgroup`): the ``seq`` ring's processes and the ``data`` replica
sets.  Over them run the ring's shift (:func:`ring_exchange`, NCCL send and
receive on the card), the all-gather of token chunks
(:func:`all_gather_tokens`) and the reductions below, each given its
``group``: the default group (the world) when it is None, and :data:`LOCAL`,
this process alone, where a mesh line stays in one process.

``UCOD_DIST=1`` (the JAX package's trigger) starts a group without a
launcher's ``WORLD_SIZE > 1``: a group of one.  One rule decides every
collective here, :func:`group_size` ``> 1`` (of the group it runs over;
:func:`process_count` for the default group; 1 for :data:`LOCAL`): over one
process, with a group of one or without a group, every function answers
for that process and launches no collective, so a group of one is exactly a
plain run.
"""

from __future__ import annotations

import functools
import operator
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

class _Local:
    """The group of this process alone (:data:`LOCAL`)."""

    def __repr__(self) -> str:
        return "LOCAL"


# the group of a mesh line that stays in this process: every collective over
# it is a no-op (None, by contrast, is the default group, the whole world)
LOCAL = _Local()

_host_group = None  # the gloo group of the host collectives, once a group is up
_subgroups: Dict[Tuple[int, ...], Any] = {}  # the subgroups made so far, by their global ranks
_cards = 1  # the cards of each process (maybe_initialize_distributed's ``cards``)
_first_card: Optional[int] = None  # the index of this process's first card, under a group on CUDA

# device collectives launched by all_reduce_mean_ and all_reduce_sum_ (calls
# and payload bytes), read by chip_smoke.py's phases P and R
grad_all_reduce = {"calls": 0, "bytes": 0}
# the ring's cross-process shifts (ring_exchange: calls and bytes sent), read
# by chip_smoke.py's phase R
ring_traffic = {"calls": 0, "bytes": 0}


def maybe_initialize_distributed(device="cuda", cards: int = 1) -> torch.device:
    """Start the process groups when the launcher asks for more than one
    process (``WORLD_SIZE > 1``) or ``UCOD_DIST=1`` is set; return this
    process's device.  Idempotent.

    On CUDA a rank's device is ``cuda:LOCAL_RANK`` (one rank per card), or,
    with ``cards`` = k > 1 (a mesh over processes of k cards each), the first
    of its cards ``cuda:LOCAL_RANK * k`` ... ``cuda:LOCAL_RANK * k + k - 1``;
    a rank without a card raises, as does a ``LOCAL_RANK`` whose cards are not
    all visible: nothing falls back to the CPU.  The rendezvous is torchrun's
    ``env://``; a group of one started by ``UCOD_DIST=1`` without
    ``MASTER_ADDR`` rendezvous in process.  Without a group the device is
    ``device`` as given."""
    global _cards, _first_card
    device = torch.device(device)
    want = int(os.environ.get("WORLD_SIZE", "1")) > 1 or os.environ.get("UCOD_DIST") == "1"
    if not want and not dist.is_initialized():
        return device
    if cards < 1:
        raise ValueError(f"cards={cards}: a process holds at least one card")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a data-parallel rank on CUDA, but CUDA is not available; pass device='cpu'")
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        first = local_rank * cards
        if first + cards > torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local_rank} with {cards} card(s) a rank needs cards {first}.."
                               f"{first + cards - 1}, but {torch.cuda.device_count()} CUDA device(s) are visible"
                               + (": one rank per card" if cards == 1 else ""))
        device = torch.device("cuda", first)
        torch.cuda.set_device(device)
        _first_card = first
    elif device.type != "cpu":
        raise ValueError(f"no process-group backend for device {device}")
    _cards = cards
    if not dist.is_initialized():
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            dist.init_process_group(backend, init_method="env://", world_size=world,
                                    rank=int(os.environ.get("RANK", "0")))
        elif world == 1:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
        else:
            raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR and MASTER_PORT: launch with torchrun "
                               "or set the env:// rendezvous variables")
    global _host_group
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return device


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def cards_per_process() -> int:
    """The ``cards`` this process was started with (1 without a group)."""
    return _cards if _group_up() else 1


def subgroup(ranks: Sequence[int]):
    """The process group of the global ``ranks`` (made once, then reused).
    Every process must ask for every subgroup, in the same order, as
    ``torch.distributed.new_group`` requires."""
    key = tuple(sorted(int(r) for r in ranks))
    if key not in _subgroups:
        _subgroups[key] = dist.new_group(list(key))
    return _subgroups[key]


def group_size(group=None) -> int:
    """The processes of ``group`` (the default group when None); 1 for
    :data:`LOCAL` and without a group.  A collective of this module runs only
    over more than one."""
    if group is LOCAL or not _group_up():
        return 1
    return dist.get_world_size() if group is None else dist.get_world_size(group)


def process_count() -> int:
    """The processes of the run: the group's size, 1 without a group.  Every
    collective of this module runs only when it is more than 1."""
    return dist.get_world_size() if _group_up() else 1


def process_index() -> int:
    return dist.get_rank() if _group_up() else 0


def process_shard() -> tuple:
    """(index, count) slice of the dataset this process reads."""
    return process_index(), process_count()


def is_main_process() -> bool:
    return process_index() == 0


def _host():
    if _host_group is None:
        raise RuntimeError("host collectives need maybe_initialize_distributed() first")
    return _host_group


def all_gather_host(values: Sequence[int]) -> np.ndarray:
    """(process_count(), len(values)) int64 array of every process's
    ``values``, over the gloo group."""
    local = torch.tensor(list(values), dtype=torch.int64)
    out = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(out, local, group=_host())
    return torch.stack(out).numpy()


def gather_object_lists(local: List[Any]) -> List[Any]:
    """Every process's list of arrays, in rank order (the reference's
    ``gather_for_metrics``); see :func:`gather_ragged`."""
    return gather_ragged(local)


def gather_ragged(local: List[Any]) -> List[Any]:
    """Ragged-count lists of equal-shape arrays from every process, in rank
    order; the local list in a world of one.

    Counts and the per-item shape are exchanged first, since a process with
    no items (a dataset smaller than the process count) has no shape of its
    own; then a float64 payload padded to the largest count, trimmed after
    the gather, as the JAX package does."""
    if process_count() == 1:
        return local
    arrays = [np.asarray(x, dtype=np.float64) for x in local]
    shape = arrays[0].shape if arrays else ()
    if len(shape) > 6:
        raise ValueError(f"gather_ragged: items of rank {len(shape)} (at most 6)")
    meta = np.zeros((8,), np.int64)
    meta[0], meta[1] = len(arrays), len(shape)
    meta[2 : 2 + len(shape)] = shape
    metas = all_gather_host(meta)
    counts = metas[:, 0]
    have = metas[counts > 0]
    if have.size == 0:
        return []
    shape = tuple(int(s) for s in have[0, 2 : 2 + int(have[0, 1])])
    payload = torch.zeros((int(counts.max()),) + shape, dtype=torch.float64)
    if arrays:
        payload[: len(arrays)] = torch.from_numpy(np.stack(arrays))
    out = [torch.empty_like(payload) for _ in range(len(counts))]
    dist.all_gather(out, payload, group=_host())
    return [x for p, c in zip(out, counts) for x in p[: int(c)].numpy()]


def barrier(name: str = "barrier") -> None:
    """Wait for every process, over the gloo group: returns at once in a
    world of one.  (``name`` labels the call site, as in the JAX package.)"""
    if process_count() > 1:
        dist.barrier(group=_host())


def _all_reduce_buckets_(tensors: Sequence[torch.Tensor], group, mean: bool) -> None:
    """Sum (or average) ``tensors`` in place over ``group``: one flat
    all-reduce per dtype (a bucket), not a call per tensor."""
    size = group_size(group)
    if size == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for bucket in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        if mean:
            flat.div_(size)
        grad_all_reduce["calls"] += 1
        grad_all_reduce["bytes"] += flat.numel() * flat.element_size()
        off = 0
        for t in bucket:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average ``tensors`` in place over ``group`` (the default group when
    None), one flat all-reduce per dtype.  No-op over one process."""
    _all_reduce_buckets_(tensors, group, mean=True)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` in place over ``group``, as :func:`all_reduce_mean_`."""
    _all_reduce_buckets_(tensors, group, mean=False)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients over the
    group's ranks (as ``torch.distributed.nn.functional.all_reduce``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (the default group when None),
    differentiable; ``x`` itself over one process."""
    return _AllReduceSum.apply(x, group) if group_size(group) > 1 else x


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """A detached copy of ``x`` averaged over ``group`` (logged losses); ``x``
    detached over one process."""
    x = x.detach()
    size = group_size(group)
    if size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out / size


class _AllGatherTokens(torch.autograd.Function):
    """The chunks of every rank of a group concatenated along ``dim`` (1:
    tokens, -1: a model axis's feature columns), in the group's rank order.
    The backward returns this rank's own slice of the incoming gradient,
    without a sum: every rank computes the same loss on the gathered tensor,
    so each rank's replica already holds the whole gradient of its chunk."""

    @staticmethod
    def forward(ctx, x, group, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.index, ctx.width, ctx.dim = dist.get_rank(group), x.shape[dim], dim
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None


def all_gather_tokens(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """(B, c, D) chunks of every rank of ``group`` -> (B, size * c, D), rank
    order (with ``dim=-1``: (B, c, size * D)), differentiable
    (:class:`_AllGatherTokens`); ``x`` over one process."""
    return _AllGatherTokens.apply(x, group, dim) if group_size(group) > 1 else x


# The two collectives of a tensor-parallel layer whose model axis crosses
# processes (Megatron's f and g): every rank of the model group holds the
# replicated residual stream and computes the same loss from it, so a
# gradient that reaches a replicated tensor is already whole on each rank,
# while one that reaches a shard's input holds that shard's part only.
# model_parallel_input marks where the replicated stream enters the
# shard-local products (identity forward, the gradients summed over the
# group in the backward); model_parallel_sum adds the row-parallel products'
# partial sums (gathered over the group and folded in shard order forward,
# the gradient passed on as it is).  A rank may hold several shards, on
# several cards: the NCCL transfers go through the rank's first card.
# Counted in tp_traffic (calls and the payload bytes a rank sends, both
# directions), read by chip_smoke.py's phase R.
tp_traffic = {"calls": 0, "bytes": 0}


def _comm_device(x: torch.Tensor) -> torch.device:
    """Where a collective over ``x`` runs: the rank's first card for a CUDA
    tensor (one NCCL communicator a group, whatever card ``x`` is on; an
    autograd device thread's current card is its own), else ``x``'s device."""
    return torch.device("cuda", _first_card) if x.is_cuda and _first_card is not None else x.device


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    out = x.to(_comm_device(x), copy=True).contiguous()
    dist.all_reduce(out, group=group)
    tp_traffic["calls"] += 1
    tp_traffic["bytes"] += out.numel() * out.element_size()
    return out.to(x.device)


class _ModelParallelInput(torch.autograd.Function):
    """One node for all of a rank's shard inputs, so that the ranks run
    their backward all-reduces in one order (autograd runs a node per card
    in that card's thread, in no order across cards)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(_sum_over(g, ctx.group) for g in grads))


class _ModelParallelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *partials):
        ctx.n = len(partials)
        local = torch.stack(partials)
        dev = _comm_device(local)
        local = local.to(dev).contiguous()
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        tp_traffic["calls"] += 1
        tp_traffic["bytes"] += local.numel() * local.element_size()
        return functools.reduce(operator.add, [t for part in parts for t in part.unbind(0)]).to(partials[0].device)

    @staticmethod
    def backward(ctx, grad):
        return (None, *([grad] * ctx.n))


def model_parallel_input(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """``xs`` (each replicated over ``group``) as the inputs of shard-local
    products: the same values; their gradients summed over the group's
    ranks, in the order of ``xs``, in one autograd node.  ``xs`` themselves
    over one process."""
    return list(_ModelParallelInput.apply(group, *xs)) if group_size(group) > 1 else list(xs)


def model_parallel_sum(partials: Sequence[torch.Tensor], group) -> torch.Tensor:
    """The sum of the partials of every shard of ``group``'s line, each rank
    giving its own in shard order (on one device), replicated on every
    rank: the ranks' partials gathered in rank order (the ranks follow the
    shard coordinate) and folded left, ``((p0 + p1) + p2) + ...``, the sum
    of one process holding every shard bit for bit; the gradient passed to
    each partial as it is.  Over one process the fold of ``partials``."""
    if group_size(group) > 1:
        return _ModelParallelSum.apply(group, *partials)
    return functools.reduce(operator.add, partials)


def ring_exchange(send: Sequence[torch.Tensor], recv: Sequence[torch.Tensor], group, send_to: Optional[int],
                  recv_from: Optional[int]) -> None:
    """One hop of a ring between processes: ``send`` goes to global rank
    ``send_to`` and ``recv`` is filled from global rank ``recv_from`` (either
    None: no such transfer), every send and receive posted together
    (``batch_isend_irecv``), so no pair of ranks waits on the other's order.
    Returns when all have completed; a failed transfer raises."""
    ops = []
    if send_to is not None:
        ops += [dist.P2POp(dist.isend, t, send_to, group) for t in send]
        ring_traffic["calls"] += 1
        ring_traffic["bytes"] += sum(t.numel() * t.element_size() for t in send)
    if recv_from is not None:
        ops += [dist.P2POp(dist.irecv, t, recv_from, group) for t in recv]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def shutdown() -> None:
    """Destroy the process groups (tests and workers that start several)."""
    global _host_group, _cards, _first_card
    if _group_up():
        dist.destroy_process_group()
    _host_group = None
    _subgroups.clear()
    _cards = 1
    _first_card = None
