"""Process groups over ``torch.distributed`` for data-parallel runs.

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

``UCOD_DIST=1`` (the JAX package's trigger) starts a group without a
launcher's ``WORLD_SIZE > 1``: a group of one.  One rule decides every
collective here, :func:`process_count` ``> 1``: in a world of one, with a
group of one or without a group, every function answers for that world
and launches no collective, so a group of one is exactly a plain run.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

_host_group = None  # the gloo group of the host collectives, once a group is up

# device collectives launched by all_reduce_mean_ (calls and payload bytes),
# read by chip_smoke.py's phase P
grad_all_reduce = {"calls": 0, "bytes": 0}


def maybe_initialize_distributed(device="cuda") -> torch.device:
    """Start the process groups when the launcher asks for more than one
    process (``WORLD_SIZE > 1``) or ``UCOD_DIST=1`` is set; return this
    process's device.  Idempotent.

    On CUDA a rank's device is ``cuda:LOCAL_RANK``; a rank without a card
    raises, as does a ``LOCAL_RANK`` past the visible card count: nothing
    falls back to the CPU.  The rendezvous is torchrun's ``env://``; a group
    of one started by ``UCOD_DIST=1`` without ``MASTER_ADDR`` rendezvous in
    process.  Without a group the device is ``device`` as given."""
    device = torch.device(device)
    want = int(os.environ.get("WORLD_SIZE", "1")) > 1 or os.environ.get("UCOD_DIST") == "1"
    if not want and not dist.is_initialized():
        return device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a data-parallel rank on CUDA, but CUDA is not available; pass device='cpu'")
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local_rank}, but {torch.cuda.device_count()} CUDA device(s) are "
                               "visible: one rank per card")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"no process-group backend for device {device}")
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


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` in place over the default group: one flat
    all-reduce per dtype (a bucket), not a call per tensor.  No-op in a
    world of one."""
    world = process_count()
    if world == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(world)
        grad_all_reduce["calls"] += 1
        grad_all_reduce["bytes"] += flat.numel() * flat.element_size()
        off = 0
        for t in group:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the default group; the backward sums the incoming gradients
    over the ranks (as ``torch.distributed.nn.functional.all_reduce``)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the default group, differentiable; ``x`` itself in
    a world of one."""
    return _AllReduceSum.apply(x) if process_count() > 1 else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """A detached copy of ``x`` averaged over the default group (logged
    losses); ``x`` detached in a world of one."""
    x = x.detach()
    if process_count() == 1:
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out / process_count()


def shutdown() -> None:
    """Destroy the process groups (tests and workers that start several)."""
    global _host_group
    if _group_up():
        dist.destroy_process_group()
    _host_group = None
