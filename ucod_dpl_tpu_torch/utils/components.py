"""Host-side connected-component analysis (8-connectivity), jax-free.

The port's copy of :mod:`ucod_dpl_tpu.utils.components`: the reference's cv2
``connectedComponents``/``boundingRect`` (``loop_UCOD_DPL.py:366-377``) by
scipy.ndimage.  The partition of the mask into components is the same; the
label numbering may differ, which the LookTwice logic never reads (it uses
per-component areas and bounding boxes).  As in the JAX package, the
native labeller (``native/cc_label.cpp`` through :mod:`.native`) is opt-in
with ``UCOD_NATIVE_CC=1`` (scipy measured faster on the JAX package's host
at 518px) and scipy the default.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy import ndimage

_STRUCTURE_8 = np.ones((3, 3), dtype=np.int32)


def connected_components(mask: np.ndarray) -> Tuple[int, np.ndarray]:
    """Label the 8-connected components of a binary mask -> (num_labels,
    labels): labels == 0 is background and num_labels counts the foreground
    components only (cv2 counts the background as a label).  With
    ``UCOD_NATIVE_CC`` set (unset, empty, ``0``, ``false`` and ``no`` are
    off) the native labeller labels it when its library builds."""
    if os.environ.get("UCOD_NATIVE_CC", "").strip().lower() not in ("", "0", "false", "no"):
        from ucod_dpl_tpu_torch.utils import native

        result = native.cc_label(mask)
        if result is not None:
            return result
    labels, num = ndimage.label(np.asarray(mask) > 0, structure=_STRUCTURE_8)
    return int(num), labels


def bounding_rect(binary: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) bounding box of the nonzero region (cv2.boundingRect)."""
    ys, xs = np.nonzero(binary)
    if ys.size == 0:
        return 0, 0, 0, 0
    x0, x1 = int(xs.min()), int(xs.max())
    y0, y1 = int(ys.min()), int(ys.max())
    return x0, y0, x1 - x0 + 1, y1 - y0 + 1
