"""The numbers that decide ``correct``: reductions in which anything
non-finite reads as infinitely wrong."""

from __future__ import annotations

import math
from typing import Iterable

import torch


def worst(values: Iterable[float]) -> float:
    out = 0.0
    for v in values:
        v = float(v)
        if not math.isfinite(v):
            return math.inf
        out = max(out, v)
    return out


def rel_norms(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row (first axis): ``||got - ref|| / ||ref||``."""
    return (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
