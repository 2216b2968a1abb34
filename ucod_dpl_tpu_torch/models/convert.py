"""Carry weights between the JAX package and the port.

The JAX package keeps its parameters as pytrees in JAX layouts (patch and
discriminator kernels HWIO, linears ``(in, out)``, decoder 1x1 convs ``(in,
out)``, LoRA ``a`` (d_in, r) and ``b`` (r, d_out)); the port keeps the same
names in PyTorch layouts (kernels OIHW, linears ``(out, in)``, LoRA ``a``
(r, d_in) and ``b`` (d_out, r)).  These functions map numpy trees of the
former to tensor trees of the latter and back, transposing explicitly and
nothing else, so a round trip is exact.  Nothing here imports JAX: JAX arrays arrive and leave
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


def tree_leaves(tree: Any) -> list:
    """The tensors of a nested dict/list/tuple of params, in ``tree_map``'s
    order."""
    leaves: list = []
    tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves


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


def quant_from_jax(qtree: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``quantize_dino_linears`` output (numpy values) -> port int8
    linears on the CPU: ``w_q`` (in, out) int8 -> (out, in), the scales and
    biases as they are."""
    return {"layers": [{name: {"w_q": torch.from_numpy(np.ascontiguousarray(np.asarray(p["w_q"], np.int8).T)),
                               "w_s": _t(p["w_s"]), "b": _t(p["b"])}
                        for name, p in layer.items()}
                       for layer in qtree["layers"]]}


def quant_to_jax(q: Mapping[str, Any]) -> Dict[str, Any]:
    """Port int8 linears -> a numpy tree in the JAX layout (inverse of
    :func:`quant_from_jax`)."""
    return {"layers": [{name: {"w_q": np.ascontiguousarray(p["w_q"].cpu().numpy().T),
                               "w_s": _n(p["w_s"]), "b": _n(p["b"])}
                        for name, p in layer.items()}
                       for layer in q["layers"]]}


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


def lora_from_jax(lora) -> list:
    """JAX ``init_lora`` adapters (numpy values) -> port adapters on the CPU."""
    return [{t: {"a": _t(np.asarray(e["a"]).T), "b": _t(np.asarray(e["b"]).T)} for t, e in layer.items()}
            for layer in lora]


def lora_to_jax(lora) -> list:
    """Port adapters -> numpy adapters in the JAX layout."""
    return [{t: {"a": np.ascontiguousarray(_n(e["a"]).T), "b": np.ascontiguousarray(_n(e["b"]).T)}
             for t, e in layer.items()}
            for layer in lora]


def _discriminator_map(params, stats, conv, kernel, linear):
    """Map a discriminator (params, stats) pair, key order kept: ``kernel``
    on the convolution kernels, ``linear`` on the linear weight, ``conv`` on
    every other array."""
    def block(p):
        return {k: kernel(v) if k == "conv_w" else conv(v) for k, v in p.items()}

    new_p = {}
    for name, v in params.items():
        if name == "convs":
            new_p[name] = [block(x) for x in v]
        elif name == "linear_w":
            new_p[name] = linear(v)
        elif name == "linear_b":
            new_p[name] = conv(v)
        else:
            new_p[name] = block(v)
    new_s = {name: [{k: conv(x) for k, x in s.items()} for s in v] if name == "convs"
             else {k: conv(x) for k, x in v.items()} for name, v in stats.items()}
    return new_p, new_s


def discriminator_from_jax(params, stats):
    """JAX ``init_discriminator`` (params, stats) (numpy values) -> port
    (params, stats) on the CPU: kernels HWIO -> OIHW, linear (flat, 1) ->
    (1, flat)."""
    return _discriminator_map(params, stats, _t, lambda w: _t(np.transpose(np.asarray(w), (3, 2, 0, 1))),
                              lambda w: _t(np.asarray(w).T))


def discriminator_to_jax(params, stats):
    """Port discriminator (params, stats) -> numpy trees in the JAX layout
    (inverse of :func:`discriminator_from_jax`)."""
    return _discriminator_map(params, stats, _n, lambda w: np.ascontiguousarray(np.transpose(_n(w), (2, 3, 1, 0))),
                              lambda w: np.ascontiguousarray(_n(w).T))
