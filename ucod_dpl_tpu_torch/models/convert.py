"""Carry weights between the JAX package and the port.

The JAX package keeps its parameters as pytrees in JAX layouts (patch
kernel HWIO, linears ``(in, out)``, decoder 1x1 convs ``(in, out)``); the
port keeps the same names in PyTorch layouts (patch kernel OIHW, linears
``(out, in)``).  These functions map numpy trees of the former to tensor
trees of the latter and back, transposing explicitly and nothing else, so a
round trip is exact.  Nothing here imports JAX: JAX arrays arrive and leave
as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ucod_dpl_tpu_torch.models.dba import RevDecoderParams

_LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a nested dict/list/tuple of params."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, RevDecoderParams):
        return RevDecoderParams(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unexpected leaf {type(tree)!r} in a params tree")


def params_to(tree: Any, device) -> Any:
    """Move every tensor of a params tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _n(x: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(x.detach().to("cpu", torch.float32).numpy())


def dino_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``init_dino``/``convert_hf_state_dict`` params (numpy values) ->
    port params on the CPU."""
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": _t(np.transpose(np.asarray(tree["patch_embed"]["kernel"]), (3, 2, 0, 1))),
            "bias": _t(tree["patch_embed"]["bias"]),
        },
        "cls_token": _t(tree["cls_token"]),
        "pos_embed": _t(tree["pos_embed"]),
        "final_norm": {k: _t(v) for k, v in tree["final_norm"].items()},
        "layers": [],
    }
    for layer in tree["layers"]:
        new = {}
        for name, p in layer.items():
            if name in _LINEARS:
                new[name] = {"w": _t(np.asarray(p["w"]).T), "b": _t(p["b"])}
            elif isinstance(p, Mapping):
                new[name] = {k: _t(v) for k, v in p.items()}
            else:
                new[name] = _t(p)
        out["layers"].append(new)
    return out


def dino_to_jax(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Port params -> a numpy tree in the JAX layout (inverse of
    :func:`dino_from_jax`)."""
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(np.transpose(_n(params["patch_embed"]["kernel"]), (2, 3, 1, 0))),
            "bias": _n(params["patch_embed"]["bias"]),
        },
        "cls_token": _n(params["cls_token"]),
        "pos_embed": _n(params["pos_embed"]),
        "final_norm": {k: _n(v) for k, v in params["final_norm"].items()},
        "layers": [],
    }
    for layer in params["layers"]:
        new = {}
        for name, p in layer.items():
            if name in _LINEARS:
                new[name] = {"w": np.ascontiguousarray(_n(p["w"]).T), "b": _n(p["b"])}
            elif isinstance(p, Mapping):
                new[name] = {k: _n(v) for k, v in p.items()}
            else:
                new[name] = _n(p)
        out["layers"].append(new)
    return out


def decoder_from_jax(p: Any) -> RevDecoderParams:
    """A JAX ``RevDecoderParams`` (or a dict with its field names; numpy
    values) -> port decoder params on the CPU."""
    get = p.__getitem__ if isinstance(p, Mapping) else lambda k: getattr(p, k)
    return RevDecoderParams(
        decoupling_w=_t(np.asarray(get("decoupling_w")).T),
        decoupling_b=_t(get("decoupling_b")),
        learnable_embedding=_t(get("learnable_embedding")),
        conv_out_fg_w=_t(np.asarray(get("conv_out_fg_w")).T),
        conv_out_fg_b=_t(get("conv_out_fg_b")),
        conv_out_bg_w=_t(np.asarray(get("conv_out_bg_w")).T),
        conv_out_bg_b=_t(get("conv_out_bg_b")),
    )


def decoder_to_jax(p: RevDecoderParams) -> Dict[str, np.ndarray]:
    """Port decoder params -> a dict of numpy arrays in the JAX layout, keyed
    by the JAX ``RevDecoderParams`` field names."""
    transposed = {"decoupling_w", "conv_out_fg_w", "conv_out_bg_w"}
    return {
        name: np.ascontiguousarray(_n(v).T) if name in transposed else _n(v)
        for name, v in p._asdict().items()
    }
