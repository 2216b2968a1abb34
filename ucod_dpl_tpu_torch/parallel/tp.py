"""Tensor-parallel sharding of the DINO ViT's parameters.

Counterpart of :mod:`ucod_dpl_tpu.parallel.tp`: the Megatron split over the
``model`` axis.  q/k/v and fc1 are column-parallel (rows of their (out, in)
weights and their biases split), the attention out-projection and fc2
row-parallel (the ``in`` columns of their weights split; their biases stay
whole and are added once, after the reduce), norms, layerscales, embeddings
and ``final_norm`` replicated.  Where JAX places one sharded array on the
mesh, the port holds one parameter dict per shard, on that shard's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

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


def _place(p, spec, m: int, tp: int, device: torch.device):
    """Leaf ``p`` (or a dict of them) cut to shard ``m`` of ``tp`` along its
    ``spec`` dim, on ``device``."""
    if isinstance(p, dict):
        return {k: _place(t, spec[k], m, tp, device) for k, t in p.items()}
    if isinstance(p, list):
        return [_place(t, sp, m, tp, device) for t, sp in zip(p, spec)]
    if spec is not None:
        n = p.shape[spec] // tp
        p = p.narrow(spec, m * n, n)
    return p.to(device).contiguous()


def place_shard(params: Dict[str, Any], m: int, tp: int, device: torch.device) -> Dict[str, Any]:
    """Shard ``m`` of ``tp`` of ``params`` (the whole ViT when ``tp`` is 1)
    on ``device``, cut as :func:`dino_param_specs` says; differentiable, and
    sharing the tensors already there."""
    return _place(params, dino_param_specs(params), m, tp, device)


def place_model_row(params: Dict[str, Any], mesh: Mesh, axis: str = "model", data: Optional[int] = None,
                    placed: Optional[Dict[Any, Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
    """``params`` (one ViT) placed for the tensor-parallel forward of this
    process: the shards of its ``axis`` coordinates (all of them on a mesh of
    one process), each on its device at ``data`` coordinate ``data`` (this
    process's first by default) and this process's first coordinate of any
    other axis; differentiable.  A (shard, device) pair already in
    ``placed`` is shared, and each new one is added to it."""
    block = mesh.local_block()
    coords = {a: v[0] for a, v in block.items()}
    if data is not None and "data" in mesh.shape:
        coords["data"] = data
    tp = mesh.shape[axis]
    placed = {} if placed is None else placed
    row = []
    for m in block[axis]:
        device = mesh.device(**{**coords, axis: m})
        if (m, device) not in placed:
            placed[(m, device)] = place_shard(params, m, tp, device)
        row.append(placed[(m, device)])
    return row


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
    placed: Dict[Any, Dict[str, Any]] = {}
    return [place_model_row(params, mesh, axis, data=d, placed=placed) for d in range(mesh.shape.get("data", 1))]
