"""Deterministic seeding (counterpart of :mod:`ucod_dpl_tpu.utils.seed`, the
reference's ``engine/utils/seed.py:6-14``)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seed(seed: int = 42) -> torch.Generator:
    """Seed Python, numpy and torch (``torch.manual_seed`` seeds every CUDA
    device too) and return a CPU ``torch.Generator`` seeded the same, the
    port's stand-in for the JAX package's PRNG key.  ``PYTHONHASHSEED`` is
    exported for child processes only: this interpreter's hash seed is fixed
    at its start."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)
