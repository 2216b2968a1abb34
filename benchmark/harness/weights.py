"""Seeded tensors made on the device in a few large draws.

A *plan* is a nested dict/list whose leaves say how to fill one tensor:
``("normal", shape, std, mean)``, ``("uniform", shape, bound)`` (uniform on
``[-bound, bound)``) or ``("const", shape, value)``.  :func:`make` draws one
normal and one uniform buffer for the whole plan from a
``torch.Generator`` on the device, then cuts each leaf from them into a tensor
of its own (fresh, aligned memory).  The same seed and tag give the same
tensors; each tag (weights, decoder, inputs, ...) has a stream of its own.

The plans follow the port's parameter trees (``models/dino.py``,
``models/dba.py``) and the
published initialisations: linears uniform in +-1/sqrt(fan_in), embeddings
N(0, 0.02).  LayerNorm and layerscale vectors are drawn around 1 and 0, not
set to them, so that a forward that ignored them would not agree.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

TAGS = {"weights": 1, "decoder": 2, "inputs": 6}


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + TAGS[tag]) % (2 ** 63))
    return g


def _leaves(plan, out):
    if isinstance(plan, tuple):
        out.append(plan)
    elif isinstance(plan, dict):
        for v in plan.values():
            _leaves(v, out)
    else:
        for v in plan:
            _leaves(v, out)
    return out


def make(plan: Any, seed: int, tag: str, device) -> Any:
    """The float32 tensors of ``plan``, in its structure (the program casts
    what it serves in bf16 itself, as it does its loaded weights)."""
    leaves = _leaves(plan, [])
    sizes = {"normal": 0, "uniform": 0}
    for kind, shape, *_ in leaves:
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    g = generator(seed, tag, device)
    bufs = {
        "normal": torch.randn(sizes["normal"], generator=g, device=device, dtype=torch.float32),
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device, dtype=torch.float32),
    }
    offsets = {"normal": 0, "uniform": 0}

    def cut(leaf):
        kind, shape = leaf[0], leaf[1]
        if kind == "const":
            return torch.full(shape, float(leaf[2]), device=device)
        n = math.prod(shape)
        x = bufs[kind][offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += n
        if kind == "normal":
            return x * leaf[2] + leaf[3]
        return (x * 2.0 - 1.0) * leaf[2]

    def build(p):
        if isinstance(p, tuple):
            return cut(p)
        if isinstance(p, dict):
            return {k: build(v) for k, v in p.items()}
        return [build(v) for v in p]

    return build(plan)


def _linear(d_in: int, d_out: int):
    s = 1.0 / math.sqrt(d_in)
    return {"w": ("uniform", (d_out, d_in), s), "b": ("uniform", (d_out,), s)}


def dino_plan(cfg: Dict[str, Any]):
    """The ViT's parameters (``models/dino.py::init_dino``'s tree)."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    f = d * cfg["mlp_ratio"]
    n_pos = (cfg["image_size"] // p) ** 2 + 1

    def norm():
        return {"scale": ("normal", (d,), 0.1, 1.0), "bias": ("normal", (d,), 0.05, 0.0)}

    layers = []
    for _ in range(cfg["num_layers"]):
        layer = {"norm1": norm(), "q": _linear(d, d), "k": _linear(d, d), "v": _linear(d, d),
                 "out": _linear(d, d), "norm2": norm(), "fc1": _linear(d, f), "fc2": _linear(f, d)}
        if cfg["use_layerscale"]:
            layer["ls1"] = ("normal", (d,), 0.1, 1.0)
            layer["ls2"] = ("normal", (d,), 0.1, 1.0)
        layers.append(layer)
    return {
        "patch_embed": {"kernel": ("normal", (d, 3, p, p), 0.02, 0.0), "bias": ("normal", (d,), 0.02, 0.0)},
        "cls_token": ("normal", (1, 1, d), 0.02, 0.0),
        "pos_embed": ("normal", (1, n_pos, d), 0.02, 0.0),
        "layers": layers,
        "final_norm": norm(),
    }


def decoder_plan(cfg: Dict[str, Any]):
    """The DBA decoder (``models/dba.py::RevDecoderParams`` fields)."""
    e, d = cfg["decoder"]["embed_dim"], cfg["hidden_size"]
    s_d, s_e = 1.0 / math.sqrt(d), 1.0 / math.sqrt(e)
    return {
        "decoupling_w": ("uniform", (2 * e, d), s_d), "decoupling_b": ("uniform", (2 * e,), s_d),
        "learnable_embedding": ("normal", (2, e), 1.0, 0.0),
        "conv_out_fg_w": ("uniform", (1, e), s_e), "conv_out_fg_b": ("uniform", (1,), s_e),
        "conv_out_bg_w": ("uniform", (1, e), s_e), "conv_out_bg_b": ("uniform", (1,), s_e),
    }


def images(seed: int, n: int, size: int, device) -> torch.Tensor:
    """``n`` pre-normalised (size, size, 3) float32 images, NHWC."""
    return make(("normal", (n, size, size, 3), 1.0, 0.0), seed, "inputs", device)
