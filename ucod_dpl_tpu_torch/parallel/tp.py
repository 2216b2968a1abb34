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

from typing import Any, Dict, List

import torch

from ucod_dpl_tpu_torch.parallel.mesh import Mesh

COLUMN_PARALLEL = ("q", "k", "v", "fc1")
ROW_PARALLEL = ("out", "fc2")


def _shard_layer(layer: Dict[str, Any], m: int, tp: int, device: torch.device) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, p in layer.items():
        if name in COLUMN_PARALLEL:
            n = p["w"].shape[0] // tp
            out[name] = {"w": p["w"][m * n:(m + 1) * n], "b": p["b"][m * n:(m + 1) * n]}
        elif name in ROW_PARALLEL:
            n = p["w"].shape[1] // tp
            out[name] = {"w": p["w"][:, m * n:(m + 1) * n], "b": p["b"]}
        else:
            out[name] = p
    return {name: _to(p, device) for name, p in out.items()}


def _to(p, device: torch.device):
    if isinstance(p, dict):
        return {k: _to(t, device) for k, t in p.items()}
    return p.to(device).contiguous()


def place_shard(params: Dict[str, Any], m: int, tp: int, device: torch.device) -> Dict[str, Any]:
    """Shard ``m`` of ``tp`` of ``params`` (the whole ViT when ``tp`` is 1)
    on ``device``; differentiable, and sharing the tensors already there."""
    return {
        "patch_embed": _to(params["patch_embed"], device),
        "cls_token": _to(params["cls_token"], device),
        "pos_embed": _to(params["pos_embed"], device),
        "layers": [_shard_layer(layer, m, tp, device) for layer in params["layers"]],
        "final_norm": _to(params["final_norm"], device),
    }


def shard_dino_params(params: Dict[str, Any], mesh: Mesh, axis: str = "model") -> List[List[Dict[str, Any]]]:
    """``params`` (one ViT, any device) -> ``shards[d][m]``: the parameter
    dict of ``axis`` shard ``m`` on the device at ``data`` coordinate ``d``
    and ``axis`` coordinate ``m`` of ``mesh``.  A shard on a device that holds
    another copy of the same shard (one card under a mesh that names it more
    than once) shares its tensors."""
    tp = mesh.shape[axis]
    for layer in params["layers"]:
        for name in COLUMN_PARALLEL:
            if layer[name]["w"].shape[0] % tp:
                raise ValueError(f"{name} has {layer[name]['w'].shape[0]} outputs, not divisible by {axis}={tp}")
    shards: List[List[Dict[str, Any]]] = []
    placed: Dict[Any, Dict[str, Any]] = {}
    for d in range(mesh.shape.get("data", 1)):
        row = []
        for m in range(tp):
            device = mesh.device(**({"data": d} if "data" in mesh.shape else {}), **{axis: m})
            if (m, device) not in placed:
                placed[(m, device)] = place_shard(params, m, tp, device)
            row.append(placed[(m, device)])
        shards.append(row)
    return shards
