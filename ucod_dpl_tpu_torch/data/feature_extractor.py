"""DINO feature extraction on a chosen torch device.

Counterpart of :mod:`ucod_dpl_tpu.data.feature_extractor` (the reference's
``data/utils/feature_extractor.py:31-59`` backbone wrapper): local weight
discovery, strict loading, a compute dtype chosen by device (bf16 on CUDA,
float32 on the CPU), and host float32 key features that are checked for
non-finite values.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ucod_dpl_tpu_torch.models.convert import params_to
from ucod_dpl_tpu_torch.models.dino import (
    DinoConfig,
    cast_params,
    dino_forward,
    init_dino,
    load_hf_checkpoint,
)
from ucod_dpl_tpu_torch.ops.quant import quantize_dino_linears

logger = logging.getLogger(__name__)

_DTYPE_BY_DEVICE = {"cuda": torch.bfloat16, "cpu": torch.float32}


def _candidate_weight_paths(fe_cfg) -> list:
    """Weight search order mirroring the reference's local->cache fallback
    (``feature_extractor.py:15-29``)."""
    name = fe_cfg.backbone.split("/")[-1]
    cands = []
    for base in (fe_cfg.get("backbone_weights"), fe_cfg.get("backbone_weight_base")):
        if not base:
            continue
        base = Path(os.path.expanduser(base))
        cands += [base, base / name, base / fe_cfg.backbone.replace("/", "--")]
    return cands


class FeatureExtractor:
    """Frozen DINO backbone exposing the key-feature hook contract."""

    def __init__(
        self,
        fe_cfg,
        *,
        device,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        strict: Optional[bool] = None,
        qkv_masters: bool = False,
        quantize: Optional[str] = None,
    ):
        """``device``: where the backbone runs (no default: nothing chooses the
        CPU because CUDA is missing).  ``compute_dtype`` defaults to bf16 on
        CUDA and float32 on the CPU; ``params`` are held cast to it once
        (:func:`~ucod_dpl_tpu_torch.models.dino.cast_params`), except the
        q/k/v weights when ``qkv_masters`` is set: LoRA training keeps those
        as float32 masters and merges its adapters into them at every step.
        ``strict`` (or ``fe_cfg.strict_weights``): missing pretrained
        weights raise instead of falling back to a random initialisation
        from ``seed``.  ``quantize="int8"``: ``extract`` runs the int8 (W8A8)
        backbone, whose linears are quantized once, from the float32
        weights before the cast, into ``_qparams`` (inference only, so not
        with ``qkv_masters``)."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize is not None and qkv_masters:
            raise ValueError("the int8 path is inference-only; qkv_masters (LoRA training) needs quantize=None")
        self.fe_cfg = fe_cfg
        self.strict = fe_cfg.get("strict_weights", False) if strict is None else strict
        self.config = DinoConfig.from_type(fe_cfg.type)
        arch = fe_cfg.get("arch")  # architecture overrides (tests, small runs)
        if arch:
            self.config = dataclasses.replace(self.config, **dict(arch))
        self.device = torch.device(device)
        if compute_dtype is None:
            if self.device.type not in _DTYPE_BY_DEVICE:
                raise ValueError(f"no default compute dtype for device {self.device}")
            compute_dtype = _DTYPE_BY_DEVICE[self.device.type]
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.quantize = quantize
        masters = params_to(self._load_params(seed), self.device)
        # quantized from the float32 weights: a bf16 copy gives other codes and scales
        self._qparams = quantize_dino_linears(masters) if quantize == "int8" else None
        self.params = cast_params(masters, compute_dtype, qkv_masters)

    def int8_params(self):
        """The backbone's int8 linears: those it holds (``quantize="int8"``),
        else quantized now from its float32 weights (loaded again from the
        same source when it holds them cast to another dtype)."""
        if self._qparams is not None:
            return self._qparams
        if self.compute_dtype == torch.float32:
            return quantize_dino_linears(self.params)
        return quantize_dino_linears(params_to(self._load_params(self.seed), self.device))

    def _load_params(self, seed: int):
        for cand in _candidate_weight_paths(self.fe_cfg):
            if cand.is_file() or (
                cand.is_dir()
                and ((cand / "model.safetensors").exists() or (cand / "pytorch_model.bin").exists())
            ):
                logger.info("Loading DINO weights from %s", cand)
                return load_hf_checkpoint(str(cand), self.config)
        msg = (
            f"No local weights found for {self.fe_cfg.backbone} "
            f"(searched {_candidate_weight_paths(self.fe_cfg)})"
        )
        if self.strict:
            raise FileNotFoundError(
                msg + "; strict weight loading is enabled (serving/eval refuses "
                "to run on random-init features)."
            )
        logger.warning(msg + "; using RANDOM initialisation — features will not match pretrained DINO.")
        return init_dino(seed, self.config)

    @staticmethod
    def _to_host_f32(t: torch.Tensor, what: str) -> np.ndarray:
        """Device tensor -> host float32, raising on non-finite values (a
        non-finite forward evaluates silently as all-background masks)."""
        arr = t.float().cpu().numpy()
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"DINO forward produced non-finite {what} "
                f"({(~np.isfinite(arr)).sum()}/{arr.size} bad) on {t.device} — "
                "kernel or numerics regression."
            )
        return arr

    def extract(self, images_nhwc: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) normalised images -> (B, h, w, hidden) float32 key
        features on the host."""
        with torch.inference_mode():
            pixels = torch.from_numpy(np.asarray(images_nhwc, np.float32)).to(self.device)
            out = dino_forward(self.params, pixels, self.config, compute_dtype=self.compute_dtype,
                               quant=self._qparams)
            return self._to_host_f32(out["key_features"], "features")
