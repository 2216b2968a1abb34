"""What the tools that start child processes or need a dataset share: the
child's environment and a synthetic COD set."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a launcher's variables, which would make a child join its parent's group
_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "UCOD_DIST")


def child_env(**extra: str) -> Dict[str, str]:
    """This process's environment without a launcher's variables, with the
    repository on ``PYTHONPATH``, unbuffered output, and ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_VARS}
    env["PYTHONUNBUFFERED"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def write_cod_set(set_dir: str, n: int, mask: str, size=(80, 100), seed: int = 0) -> None:
    """``set_dir/{im,gt}``: ``n`` seeded noise JPEGs ``img{i}.jpg`` with a
    ground truth ``img{i}.png`` each.  ``mask="rect"``: a 20 x 30 rectangle
    moving down one row per image on plain noise (the JAX package's eval
    fixture); ``mask="disc"``: a bright disc of radius ``6 + 3 i`` at a
    seeded centre on dark noise (its soak's set: small and large objects,
    so that both LookTwice branches run)."""
    from PIL import Image

    if mask not in ("rect", "disc"):
        raise ValueError(f"mask must be 'rect' or 'disc'; got {mask!r}")
    im, gt = os.path.join(set_dir, "im"), os.path.join(set_dir, "gt")
    os.makedirs(im, exist_ok=True)
    os.makedirs(gt, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        if mask == "rect":
            img = rng.random((h, w, 3))
            obj = np.zeros(size, dtype=bool)
            obj[20 + i:40 + i, 30:60] = True
        else:
            base = rng.random((h, w, 3)) * 0.3
            cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
            obj = (yy - cy) ** 2 + (xx - cx) ** 2 < (6 + 3 * i) ** 2
            img = np.clip(base + obj[..., None] * 0.6, 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(im, f"img{i}.jpg"))
        Image.fromarray(obj.astype(np.uint8) * 255).save(os.path.join(gt, f"img{i}.png"))
