"""Debug visualisation: bbox/mask overlays, jax-free; the port's copy of
:mod:`ucod_dpl_tpu.utils.visualize` (counterpart of
``engine/utils/show_imgs.py:6-48`` — without its latent missing-torch-import
bug). Matplotlib is imported lazily and gated, keeping headless runs clean.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import numpy as np


def draw_bboxes_on_image_and_save(
    image: np.ndarray,
    bboxes: Iterable[Sequence[float]],
    save_path: str,
    mask: Optional[np.ndarray] = None,
    color: str = "red",
    linewidth: float = 1.5,
) -> None:
    """Overlay (x, y, w, h) boxes (and optionally a mask) on an image and
    save as PNG."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.patches as patches
        import matplotlib.pyplot as plt
    except ImportError:  # visualisation is strictly optional
        return

    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(image)
    if mask is not None:
        ax.imshow(np.squeeze(mask), alpha=0.4, cmap="jet")
    for bbox in bboxes or []:
        x, y, w, h = bbox[:4]
        ax.add_patch(
            patches.Rectangle((x, y), w, h, fill=False, edgecolor=color, linewidth=linewidth)
        )
    ax.axis("off")
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
