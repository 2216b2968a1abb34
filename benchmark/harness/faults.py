"""Faults planted in the program underneath a run, to show that the check
catches them (``tests/test_bench_faults.py``; on the card ``calibrate.py
--fault``).  Each is a context manager that patches one program function
where its caller looks it up, and restores it on exit.

- ``altered``: one answer changed where it is produced: image 0's result
  (foreground logits or key features) is image 1's.
- ``half``: half of the batch left out: the program computes the first half
  only, and the second half's results copy the first's.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def _swap01(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[0] = x[1]
    return x


def _predict_altered(orig):
    def f(*args, **kwargs):
        fg, bg, ortho = orig(*args, **kwargs)
        return _swap01(fg), bg, ortho
    return f


def _predict_half(orig):
    def f(backbone, params, pixels, *args, **kwargs):
        fg, bg, ortho = orig(backbone, params, pixels[: pixels.shape[0] // 2], *args, **kwargs)
        return torch.cat([fg, fg]), torch.cat([bg, bg]), ortho
    return f


def _features_altered(orig):
    def f(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        out["key_features"] = _swap01(out["key_features"])
        return out
    return f


def _extract_half(orig):
    def f(params, pixels, *args, **kwargs):
        out = orig(params, pixels[: pixels.shape[0] // 2], *args, **kwargs)
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return f


FAULTS = {
    ("predict", "altered"): ("ucod_dpl_tpu_torch.serving", "fg_logits_live", _predict_altered),
    ("predict", "half"): ("ucod_dpl_tpu_torch.serving", "fg_logits_live", _predict_half),
    ("extract", "altered"): ("ucod_dpl_tpu_torch.data.feature_extractor", "dino_forward", _features_altered),
    ("extract", "half"): ("ucod_dpl_tpu_torch.data.feature_extractor", "dino_forward", _extract_half),
}


def planted(driver: str, fault: str):
    """The context manager planting ``fault`` under cells of ``driver``."""
    module, attr, make = FAULTS[(driver, fault)]
    return patched(module, attr, make)
