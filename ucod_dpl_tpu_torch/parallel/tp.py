"""Tensor-parallel sharding of the DINO ViT's parameters.

Counterpart of :mod:`ucod_dpl_tpu.parallel.tp`: the Megatron split over the
``model`` axis.  q/k/v and fc1 are column-parallel (rows of their (out, in)
weights and their biases split), the attention out-projection and fc2
row-parallel (the ``in`` columns of their weights split; their biases stay
whole and are added once, after the reduce), norms, layerscales, embeddings
and ``final_norm`` replicated.  Where JAX places one sharded array on the
mesh, the port holds one parameter dict per shard, on that shard's device.

A tensor read on several cards of one process is copied to them by
:func:`to_devices`, whose backward sums the copies' gradients in a fixed
order: autograd adds the gradients that reach one tensor in the order its
device threads deliver them, and three floating-point terms do not give the
same sum in every order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ucod_dpl_tpu_torch.parallel.mesh import Mesh

COLUMN_PARALLEL = ("q", "k", "v", "fc1")
ROW_PARALLEL = ("out", "fc2")


def dino_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The split of each leaf of ``params`` over the ``model`` axis, a tree of
    the same structure (the JAX ``dino_param_specs``, whose ``PartitionSpec``
    leaves name the axis on the JAX ``(in, out)`` layout): the dimension of
    the port's ``(out, in)`` layout that is split, or None where the leaf is
    replicated.  Column-parallel q/k/v/fc1 split their weights' and biases'
    dim 0 (the outputs), row-parallel out/fc2 their weights' dim 1 (the
    inputs) and keep their biases whole; everything else is replicated."""

    def layer_spec(layer):
        spec: Dict[str, Any] = {}
        for name, p in layer.items():
            if name in COLUMN_PARALLEL:
                spec[name] = {"w": 0, "b": 0}
            elif name in ROW_PARALLEL:
                spec[name] = {"w": 1, "b": None}
            else:
                spec[name] = _replicated(p)
        return spec

    return {name: [layer_spec(layer) for layer in p] if name == "layers" else _replicated(p)
            for name, p in params.items()}


def _replicated(p):
    return {k: _replicated(v) for k, v in p.items()} if isinstance(p, dict) else None


class ToDevices(torch.autograd.Function):
    """``x`` copied to each of ``devices`` (distinct; a device that holds
    ``x`` gets ``x`` itself).  The backward sums the copies' gradients on
    ``x``'s device in the order of ``devices``, as one f32 left fold, and
    casts the sum to ``x``'s dtype: ``x`` receives one gradient term for all
    its copies, whatever order they arrive in."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, devices: Tuple[torch.device, ...]):
        ctx.set_materialize_grads(False)
        ctx.src = (x.device, x.dtype)
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        device, dtype = ctx.src
        acc = None
        for g in grads:
            if g is not None:
                g = g.to(device, torch.float32)
                acc = g if acc is None else acc + g
        return (None if acc is None else acc.to(dtype)), None


def to_devices(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each of ``devices`` (one copy per distinct device, shared
    where a device repeats).  Over two or more distinct devices through
    :class:`ToDevices`, so the gradients of the copies are added in the order
    of ``devices``; over one, ``x.to(device)`` as it is."""
    distinct = list(dict.fromkeys(devices))
    if len(distinct) == 1:
        return [x.to(distinct[0])] * len(devices)
    on = dict(zip(distinct, ToDevices.apply(x, tuple(distinct))))
    return [on[d] for d in devices]


def _place(p, spec, groups, tp: int, n_targets: int) -> list:
    """Leaf ``p`` (or a dict or list of them) cut and placed for each of
    ``n_targets`` targets: one tree per target.  ``groups`` (from
    :func:`place_grid`) maps, for a replicated leaf (``groups[0]``) and for a
    split one by shard (``groups[1]``), each piece to the targets that share
    it and their devices."""
    if isinstance(p, dict):
        parts = {k: _place(t, spec[k], groups, tp, n_targets) for k, t in p.items()}
        return [{k: v[j] for k, v in parts.items()} for j in range(n_targets)]
    if isinstance(p, list):
        parts = [_place(t, sp, groups, tp, n_targets) for t, sp in zip(p, spec)]
        return [[v[j] for v in parts] for j in range(n_targets)]
    out: list = [None] * n_targets
    for m, (idx, devices) in groups[spec is not None].items():
        piece = p
        if spec is not None:
            n = p.shape[spec] // tp
            piece = p.narrow(spec, m * n, n)
        for j, t in zip(idx, to_devices(piece, devices)):
            out[j] = t.contiguous()
    return out


def place_grid(params: Dict[str, Any], rows: Sequence[Sequence[Tuple[int, torch.device]]],
               tp: int) -> List[List[Dict[str, Any]]]:
    """``params`` placed as ``rows``: for each ``(m, device)``, shard ``m`` of
    ``tp`` on ``device``, cut as :func:`dino_param_specs` says;
    differentiable, sharing the tensors already on a device.  Each distinct
    pair is placed once and shared, and each piece read on several cards (a
    replicated leaf, or one shard on several devices) is copied there by
    :func:`to_devices`."""
    distinct = list(dict.fromkeys(t for row in rows for t in row))
    by_m: Dict[int, Tuple[List[int], List[torch.device]]] = {}
    for j, (m, device) in enumerate(distinct):
        idx, devices = by_m.setdefault(m, ([], []))
        idx.append(j)
        devices.append(device)
    whole = {None: (list(range(len(distinct))), [d for _, d in distinct])}
    placed = dict(zip(distinct, _place(params, dino_param_specs(params), (whole, by_m), tp, len(distinct))))
    return [[placed[t] for t in row] for row in rows]


def place_shard(params: Dict[str, Any], m: int, tp: int, device: torch.device) -> Dict[str, Any]:
    """Shard ``m`` of ``tp`` of ``params`` (the whole ViT when ``tp`` is 1)
    on ``device`` (:func:`place_grid` of one target)."""
    return place_grid(params, [[(m, device)]], tp)[0][0]


def _row_targets(mesh: Mesh, axis: str, data: Optional[int]) -> List[Tuple[int, torch.device]]:
    block = mesh.local_block()
    coords = {a: v[0] for a, v in block.items()}
    if data is not None and "data" in mesh.shape:
        coords["data"] = data
    return [(m, mesh.device(**{**coords, axis: m})) for m in block[axis]]


def place_model_row(params: Dict[str, Any], mesh: Mesh, axis: str = "model",
                    data: Optional[int] = None) -> List[Dict[str, Any]]:
    """``params`` (one ViT) placed for the tensor-parallel forward of this
    process: the shards of its ``axis`` coordinates (all of them on a mesh of
    one process), each on its device at ``data`` coordinate ``data`` (this
    process's first by default) and this process's first coordinate of any
    other axis; differentiable."""
    return place_grid(params, [_row_targets(mesh, axis, data)], mesh.shape[axis])[0]


def shard_dino_params(params: Dict[str, Any], mesh: Mesh, axis: str = "model") -> List[List[Dict[str, Any]]]:
    """``params`` (one ViT, any device) -> ``shards[d][m]``: the parameter
    dict of ``axis`` shard ``m`` on the device at ``data`` coordinate ``d``
    and ``axis`` coordinate ``m`` of ``mesh`` (of one process).  A shard on a
    device that holds another copy of the same shard (one card under a mesh
    that names it more than once) shares its tensors."""
    tp = mesh.shape[axis]
    for layer in params["layers"]:
        for name in COLUMN_PARALLEL:
            if layer[name]["w"].shape[0] % tp:
                raise ValueError(f"{name} has {layer[name]['w'].shape[0]} outputs, not divisible by {axis}={tp}")
    return place_grid(params, [_row_targets(mesh, axis, d) for d in range(mesh.shape.get("data", 1))], tp)
