"""Fixed-strategy pseudo-label cues, jax-free: DINO CLS attention and cosine
similarity to a background reference patch.

Counterpart of :mod:`ucod_dpl_tpu.ops.pseudo_label` (the reference's
``data/utils/found_bkg_mask.py:4-86``: CroW-style per-head sparsity
weighting of the key descriptors, cosine similarity against the least
attended patch) as batched tensor work on the batch's device, and the
host-side small-component cleanup of ``generate_pseudo_label.py:30-67``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear
from ucod_dpl_tpu_torch.utils.components import connected_components


def compute_background_mask(
    cls_attention: torch.Tensor,
    key_tokens: torch.Tensor,
    grid_hw: Tuple[int, int],
    th_bkg: float,
    up_size: Optional[int] = None,
    epsilon: float = 1e-10,
    apply_weights: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cls_attention`` (B, heads, 1+N) and ``key_tokens`` (B, 1+N, C) of
    the last layer -> ``(bkg_mask, weighted_sim_map)``, both (B, up, up)
    float32 on their device; ``bkg_mask`` is 1 on background.

    The reference's algebra, including its batch-global max normalisation
    of the similarity map: only the reference patch's row of the cosine
    matrix is formed, (B, 1, C) against (B, N, C)."""
    h, w = grid_hw
    if up_size is None:
        up_size = w
    nb, nh = cls_attention.shape[:2]
    c = key_tokens.shape[-1]
    dim = c // nh

    att = cls_attention[:, :, 1:].reshape(nb, nh, h, w).float()
    att = interpolate_bilinear(att, (up_size, up_size))
    n_up = up_size * up_size
    descs = key_tokens[:, 1:, :].float()

    # CroW sparsity weighting: per-head share of above-mean attention
    threshold = att.reshape(nb, -1).mean(dim=1)
    q = (att.reshape(nb, nh, n_up) > threshold[:, None, None]).sum(dim=2).float() / n_up
    beta = torch.log((q + epsilon).sum(dim=1)[:, None] / (q + epsilon))
    if apply_weights:
        descs = (descs.reshape(nb, -1, nh, dim) * beta[:, None, :, None]).reshape(nb, -1, c)

    # descriptors onto the up-sized grid (the identity at equal size)
    descs = descs.reshape(nb, h, w, c).permute(0, 3, 1, 2)
    descs = interpolate_bilinear(descs, (up_size, up_size))
    descs = descs.permute(0, 2, 3, 1).reshape(nb, n_up, c)
    descs = descs / torch.linalg.norm(descs, dim=-1, keepdim=True).clamp_min(1e-12)

    # the reference patch: the least attended (beta-weighted) one
    att_w = att * beta[:, :, None, None] if apply_weights else att
    ref_idx = torch.argmin(att_w.sum(dim=1).reshape(nb, -1), dim=-1)
    ref_desc = descs[torch.arange(nb, device=descs.device), ref_idx][:, None]  # (B, 1, C)
    sim_row = torch.einsum("boc,bnc->bn", ref_desc, descs).reshape(nb, up_size, up_size)

    bkg_mask = (sim_row > th_bkg).float()
    sim_map = 1.0 - sim_row
    sim_map = sim_map / (sim_map.max() + 1e-10)  # batch-global max, as the reference
    return bkg_mask, sim_map * (1.0 - bkg_mask)


def refine_small_components(mask: np.ndarray, area_threshold: int = 4) -> np.ndarray:
    """Flip each connected component under ``area_threshold`` pixels whose
    surroundings are all of the opposite label (host-side; the reference's
    ``refine_post_process``).  Components are visited in label order and
    each flip is seen by the next, as in the JAX package."""
    mask = np.asarray(mask).astype(np.uint8)
    squeezed = np.squeeze(mask)
    refined = squeezed.copy()
    num, labels = connected_components(squeezed)
    hh, ww = squeezed.shape
    for lab in range(1, num + 1):
        comp = labels == lab
        if int(comp.sum()) >= area_threshold:
            continue
        ys, xs = np.nonzero(comp)
        y, x = ys.min(), xs.min()
        height, width = ys.max() - y + 1, xs.max() - x + 1
        y0, x0 = max(y - 1, 0), max(x - 1, 0)
        y1, x1 = min(y + height + 1, hh), min(x + width + 1, ww)
        surrounding = refined[y0:y1, x0:x1][~comp[y0:y1, x0:x1]]
        opposite = 1 - refined[y + height // 2, x + width // 2]
        if surrounding.size and np.all(surrounding == opposite):
            refined[y : y + height, x : x + width][comp[y : y + height, x : x + width]] = opposite
    return refined.astype(np.float32)
