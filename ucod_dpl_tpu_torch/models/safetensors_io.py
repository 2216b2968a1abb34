"""Decoder checkpoints in the reference's safetensors format.

Counterpart of :mod:`ucod_dpl_tpu.models.safetensors_io`.  The released
UCOD-DPL checkpoints hold 14 float32 tensors,
``decoder{,_ema}.{decoupling,conv_out_fg,conv_out_bg}.{weight,bias}`` (OIHW
1x1 kernels) and ``decoder{,_ema}.learnable_embedding``.  The port keeps
the kernels as ``(out, in)`` matrices, so loading drops the 1x1 tail and
saving restores it.  ``safetensors`` is imported only when a file is read
or written.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from ucod_dpl_tpu_torch.models.dba import RevDecoderParams

_CONVS = ("decoupling", "conv_out_fg", "conv_out_bg")


def _tower_from_flat(flat: Dict[str, torch.Tensor], prefix: str) -> RevDecoderParams:
    def get(name):
        key = f"{prefix}.{name}"
        if key not in flat:
            raise KeyError(f"Checkpoint missing tensor {key!r}; has {sorted(flat)[:6]}...")
        return flat[key].float()

    fields = {}
    for conv in _CONVS:
        fields[f"{conv}_w"] = get(f"{conv}.weight")[:, :, 0, 0].contiguous()
        fields[f"{conv}_b"] = get(f"{conv}.bias")
    return RevDecoderParams(
        decoupling_w=fields["decoupling_w"],
        decoupling_b=fields["decoupling_b"],
        learnable_embedding=get("learnable_embedding"),
        conv_out_fg_w=fields["conv_out_fg_w"],
        conv_out_fg_b=fields["conv_out_fg_b"],
        conv_out_bg_w=fields["conv_out_bg_w"],
        conv_out_bg_b=fields["conv_out_bg_b"],
    )


def _tower_to_flat(params: RevDecoderParams, prefix: str) -> Dict[str, torch.Tensor]:
    def f32(x):
        # safetensors serialises the raw buffer: contiguous copies only
        return x.detach().to("cpu", torch.float32).contiguous()

    flat = {f"{prefix}.learnable_embedding": f32(params.learnable_embedding)}
    for conv in _CONVS:
        flat[f"{prefix}.{conv}.weight"] = f32(getattr(params, f"{conv}_w")[:, :, None, None])
        flat[f"{prefix}.{conv}.bias"] = f32(getattr(params, f"{conv}_b"))
    return flat


def load_decoder_checkpoint(path: str) -> Tuple[RevDecoderParams, RevDecoderParams]:
    """Reference-format checkpoint -> (student, ema_teacher) params on the CPU."""
    from safetensors.torch import load_file

    flat = load_file(path)
    return _tower_from_flat(flat, "decoder"), _tower_from_flat(flat, "decoder_ema")


def save_file_atomic(flat: Dict[str, torch.Tensor], path: str) -> None:
    """Write contiguous CPU tensors as safetensors via a temporary file and
    ``os.replace``, so a crash never leaves a truncated file."""
    from safetensors.torch import save_file

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        save_file(flat, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_decoder_checkpoint(path: str, decoder: RevDecoderParams, decoder_ema: RevDecoderParams) -> None:
    """Write both towers in the reference layout (atomically)."""
    save_file_atomic({**_tower_to_flat(decoder, "decoder"), **_tower_to_flat(decoder_ema, "decoder_ema")}, path)
