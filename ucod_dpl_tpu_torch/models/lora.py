"""LoRA adaptation of the DINO ViT backbone in PyTorch.

Counterpart of :mod:`ucod_dpl_tpu.models.lora`: low-rank deltas on the q/k/v
projections of every block (the reference's broken end-to-end intent,
``models/modules/full_model.py:47-72``: peft r=2, alpha=4 on query/key/value),
trained with the frozen base weights and mergeable back into dense weights.

Adapters are a list (one entry per layer) of ``{"q"|"k"|"v": {"a": (r,
d_in), "b": (d_out, r)}}`` in peft's ``lora_A``/``lora_B`` layout, so the
merged weight is ``W + (alpha / r) * b @ a`` in the port's ``(out, in)``
layout.  Checkpoints use the JAX package's file format (``a`` as ``(d_in,
r)``, ``b`` as ``(r, d_out)``), so either package reads the other's files.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_TARGETS = ("q", "k", "v")

Lora = List[Dict[str, Dict[str, torch.Tensor]]]


def init_lora(seed: int, dino_params: Dict[str, Any], rank: int = 2) -> Lora:
    """A ~ N(0, 0.02), B = 0 (so the adapted model starts as the base), from
    ``numpy.random.default_rng(seed)``, float32 on the device of the
    weights."""
    rng = np.random.default_rng(seed)
    layers: Lora = []
    for layer in dino_params["layers"]:
        entry = {}
        for t in _TARGETS:
            w = layer[t]["w"]
            d_out, d_in = w.shape
            a = rng.standard_normal((rank, d_in), dtype=np.float32) * np.float32(0.02)
            entry[t] = {"a": torch.from_numpy(a).to(w.device),
                        "b": torch.zeros(d_out, rank, device=w.device)}
        layers.append(entry)
    return layers


def apply_lora(dino_params: Dict[str, Any], lora: Lora, rank: int = 2, alpha: float = 4.0) -> Dict[str, Any]:
    """Params with ``W' = W + (alpha / rank) * b @ a`` merged into the q/k/v
    weights, in float32 (differentiable w.r.t. the adapters).  Pass float32
    q/k/v weights (``cast_params(..., qkv_masters=True)``): merged into a
    bf16 weight, the small delta is lost."""
    scale = alpha / rank
    new_layers = []
    for layer, entry in zip(dino_params["layers"], lora):
        new_layer = dict(layer)
        for t in _TARGETS:
            delta = entry[t]["b"] @ entry[t]["a"]
            new_layer[t] = {"w": layer[t]["w"].float() + scale * delta, "b": layer[t]["b"]}
        new_layers.append(new_layer)
    return {**dino_params, "layers": new_layers}


def lora_forward(dino_params, lora: Lora, pixels, cfg, rank: int = 2, alpha: float = 4.0, **kwargs):
    """Forward through the LoRA-adapted backbone, always on the differentiated
    routing (``dino_forward(differentiable=True)``: LayerNorm + dense q/k/v,
    attention through the forward-LSE and backward kernels; ``sp_shard=``
    passes through, the ring of the sequence-parallel forward, and
    ``tp_shard=``, the merged weights placed on the model shards).
    Gradients reach the adapters; the base weights stay frozen as long as
    they do not require grad."""
    from ucod_dpl_tpu_torch.models.dino import dino_forward

    return dino_forward(apply_lora(dino_params, lora, rank, alpha), pixels, cfg, differentiable=True, **kwargs)


# ---------------------------------------------------------------------------
# checkpoint IO
# ---------------------------------------------------------------------------


def save_lora_checkpoint(path: str, lora: Lora) -> None:
    """Adapters as safetensors with flat keys ``layers.{i}.{q|k|v}.{a|b}`` in
    the JAX package's layout (``a`` (d_in, r), ``b`` (r, d_out))."""
    from ucod_dpl_tpu_torch.models.safetensors_io import save_file_atomic

    flat = {}
    for i, entry in enumerate(lora):
        for t in _TARGETS:
            for name in ("a", "b"):
                flat[f"layers.{i}.{t}.{name}"] = entry[t][name].detach().to("cpu", torch.float32).t().contiguous()
    save_file_atomic(flat, path)


def load_lora_checkpoint(path: str) -> Lora:
    """Adapters written by :func:`save_lora_checkpoint` (or by the JAX
    package), on the CPU."""
    from safetensors.torch import load_file

    flat = load_file(path)
    n_layers = 1 + max(int(k.split(".")[1]) for k in flat)
    return [
        {t: {name: flat[f"layers.{i}.{t}.{name}"].float().t().contiguous() for name in ("a", "b")}
         for t in _TARGETS}
        for i in range(n_layers)
    ]


def save_merged_backbone(
    path: str, dino_params: Dict[str, Any], lora: Lora, cfg, rank: int = 2, alpha: float = 4.0
) -> None:
    """Merge the adapters densely and export a standard HuggingFace-layout
    safetensors checkpoint, which serving and eval load through the ordinary
    weight path at exactly the base model's cost."""
    from ucod_dpl_tpu_torch.models.dino import save_hf_checkpoint

    with torch.no_grad():
        save_hf_checkpoint(path, apply_lora(dino_params, lora, rank, alpha), cfg)
