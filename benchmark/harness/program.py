"""The system under test, built from the benchmark's own tensors and
configuration: ``ucod_dpl_tpu_torch``'s ``FeatureExtractor`` fed seeded
weights; and what holds a run to the precision its cell states."""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

ARCH_KEYS = ("variant", "image_size", "patch_size", "hidden_size", "num_layers", "num_heads", "mlp_ratio",
             "layer_norm_eps", "use_layerscale")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
INT8_KERNELS = ("K8", "K9", "K10", "K11")  # the port's int8 kernels, by ``ops.kernel_wrappers`` id
LOW_PRECISION = {getattr(torch, n) for n in ("int8", "uint8", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                                             "float8_e5m2fnuz") if hasattr(torch, n)}
_SWITCHED = {"quantize": None}


def extractor(cfg: Dict[str, Any], masters: Dict[str, Any], device, dtype: torch.dtype, **kw):
    """A ``FeatureExtractor`` of ``cfg``'s architecture whose float32 master
    weights are ``masters`` (the program casts, quantizes or keeps them as
    its options say); under :func:`int8_path` the program's int8 path."""
    from ucod_dpl_tpu_torch.config import CfgNode
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor

    class SeededExtractor(FeatureExtractor):
        def _load_params(self, seed):
            return masters

    fe_cfg = CfgNode({"type": cfg["variant"], "backbone": cfg["backbone"],
                      "arch": {k: cfg[k] for k in ARCH_KEYS}})
    kw["quantize"] = _SWITCHED["quantize"] or kw.get("quantize")
    return SeededExtractor(fe_cfg, device=device, compute_dtype=dtype, strict=False, **kw)


@contextlib.contextmanager
def int8_path():
    """The program's own int8 path (``quantize="int8"``) switched on in the
    extractors built inside, whatever the cell states: the control that
    ``calibrate.py --int8`` runs."""
    _SWITCHED["quantize"] = "int8"
    try:
        yield
    finally:
        _SWITCHED["quantize"] = None


def int8_launches() -> int:
    """The port's int8 kernels' launches so far (counted on the card only)."""
    from ucod_dpl_tpu_torch import ops

    counts = ops.launches()
    return sum(counts[k] for k in INT8_KERNELS)


def low_precision_elements(root) -> int:
    """Elements of the int8, uint8 and fp8 tensors and arrays that ``root``
    holds, through the attributes of the benchmark's and the port's objects
    and through dicts, lists and tuples."""
    seen, stack, n = set(), [root], 0
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            n += x.numel() if x.dtype in LOW_PRECISION else 0
        elif isinstance(x, np.ndarray):
            n += x.size if x.dtype in (np.int8, np.uint8) else 0
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif type(x).__module__.startswith(("ucod_dpl_tpu_torch", "benchmark")) and hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return n


def precision_checks(int8_window: int, held: int) -> Dict[str, tuple]:
    """A cell that states bf16 (or float32) serving runs none of the port's
    int8 kernels in its window and holds no quantized weight: both limits 0."""
    return {"int8_launches": (float(int8_window), 0.0), "lowp_elements": (float(held), 0.0)}
