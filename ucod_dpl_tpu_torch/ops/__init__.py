"""Kernels and plain tensor ops of the PyTorch port."""

from __future__ import annotations

from typing import Any, Dict


def kernel_wrappers() -> Dict[str, Any]:
    """The wrapper of each kernel, by the id of the TPU kernel it ports
    (K3 and K4 are one backward); each counts its launches in
    ``.launches``, on CUDA tensors only."""
    from .attention import (
        attention_outproj_residual,
        heads_attention,
        packed_attention,
        packed_attention_bwd,
        packed_attention_fwd_lse,
    )
    from .fused_layers import (
        dense_quant_w8a8,
        layernorm_fc1_gelu,
        layernorm_fc1_gelu_w8a8,
        layernorm_mlp_w8a8,
        layernorm_qkv,
        layernorm_qkv_w8a8,
    )
    from .patch_embed import patch_embed

    return {"K1": packed_attention, "K2": packed_attention_fwd_lse, "K3/K4": packed_attention_bwd,
            "K5": heads_attention, "K6": layernorm_qkv, "K7": layernorm_fc1_gelu, "K8": layernorm_qkv_w8a8,
            "K9": layernorm_fc1_gelu_w8a8, "K10": dense_quant_w8a8, "K11": layernorm_mlp_w8a8,
            "K12": attention_outproj_residual, "K13": patch_embed}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    """Every kernel's launch count since its last reset, by kernel id."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}
