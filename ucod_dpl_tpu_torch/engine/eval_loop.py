"""LookTwice host helpers (pure numpy), jax-free.

Counterpart of the host half of :mod:`ucod_dpl_tpu.engine.eval_loop`
(the reference's ``ValLoop_Look_Twice``, ``loop_UCOD_DPL.py:326-417``):
connected components -> bbox expansion -> crops of the original image ->
one batched re-inference -> refined masks pasted back.  The device pass is
the caller's ``crop_batch_fn``; Pillow is imported only when crops are cut
or pasted.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

from ucod_dpl_tpu_torch.utils.components import bounding_rect, connected_components
from ucod_dpl_tpu_torch.data.transforms import image_transform

# crop batches are padded to these sizes, as in the JAX package (which
# compiles one program per size)
_CROP_BUCKETS = (4, 16)


def _bucket(n: int) -> int:
    for b in _CROP_BUCKETS:
        if n <= b:
            return b
    return ((n + _CROP_BUCKETS[-1] - 1) // _CROP_BUCKETS[-1]) * _CROP_BUCKETS[-1]


def batched_crop_infer(crops: List[np.ndarray], crop_batch_fn) -> np.ndarray:
    """Run crop arrays through ``crop_batch_fn`` in bucket-padded chunks of at
    most the largest bucket."""
    cap = _CROP_BUCKETS[-1]
    parts = []
    for s0 in range(0, len(crops), cap):
        chunk = crops[s0 : s0 + cap]
        batch = np.zeros((_bucket(len(chunk)), *chunk[0].shape), dtype=np.float32)
        batch[: len(chunk)] = np.stack(chunk)
        parts.append(np.asarray(crop_batch_fn(batch))[: len(chunk)])
    return np.concatenate(parts)


def expand_bbox(
    mask: np.ndarray,
    bbox: Tuple[int, int, int, int],
    img_width: int,
    img_height: int,
    expand_type: str = "const",
    scale: float = 1.3,
) -> List[int]:
    """Grow a component bbox; 'dynamic' scales by sqrt(2 - br/fr)
    (loop_UCOD_DPL.py:399-417), clamped at 0 where the reference would raise."""
    x, y, w, h = bbox
    if expand_type == "dynamic":
        fr = mask[y : y + h, x : x + w].sum() / (h * w)
        br = (h * y) / (mask.shape[-2] * mask.shape[-1])
        scale = math.sqrt(max(1.0 - br / fr + 1.0, 0.0)) if fr > 0 else scale
    new_w = w * scale
    new_h = h * scale
    new_x = max(0.0, x - (new_w - w) / 2)
    if new_x + new_w > img_width:
        new_x = img_width - new_w
    new_y = max(0.0, y - (new_h - h) / 2)
    if new_y + new_h > img_height:
        new_y = img_height - new_h
    return [int(new_x), int(new_y), int(new_w), int(new_h)]


def resize_bbox(bbox, original_width, original_height, new_width, new_height) -> List[int]:
    x, y, w, h = bbox
    ws = new_width / original_width
    hs = new_height / original_height
    return [int(x * ws), int(y * hs), int(w * ws), int(h * hs)]


def find_refine_bboxes(
    binary_hw: np.ndarray, img_size: Tuple[int, int], look_twice_th: float, expand_type: str
) -> Optional[List[List[int]]]:
    """Component analysis -> bboxes to look at again, or None
    (loop_UCOD_DPL.py:354-384).  ``binary_hw``: (H, W) {0, 1}."""
    h, w = img_size
    num, labels = connected_components(binary_hw)
    if num == 0:
        return [[129, 129, 259, 259]]  # the reference's fixed centre box (518px)
    areas = np.bincount(labels.ravel(), minlength=num + 1)[1:] / (h * w)
    if areas.max() >= look_twice_th:
        return None
    bboxes = []
    for i in np.nonzero(areas > 0.01)[0]:
        comp = (labels == i + 1).astype(np.uint8)
        bboxes.append(expand_bbox(comp, bounding_rect(comp), h, w, expand_type=expand_type))
    bboxes.sort(key=lambda b: -b[2] * b[3])
    return bboxes


def prepare_crops(img, bboxes: List[List[int]], img_size: Tuple[int, int]):
    """Drop degenerate boxes, open the image (path or PIL) and cut the
    normalised crop arrays (loop_UCOD_DPL.py:334-342) -> (bboxes, crops)."""
    bboxes = [b for b in bboxes if b[2] > 0 and b[3] > 0]
    if not bboxes:
        return [], []
    if isinstance(img, (str, os.PathLike)):
        from PIL import Image

        img = Image.open(img)
    ih, iw = img_size
    crops = []
    for bbox in bboxes:
        x, y, w, h = resize_bbox(bbox, iw, ih, img.size[0], img.size[1])
        cropped = img.crop((x, y, x + max(w, 1), y + max(h, 1)))
        crops.append(image_transform(cropped.convert("RGB"), img_size))
    return bboxes, crops


def paste_refined(mask_hw: np.ndarray, bboxes: List[List[int]], preds: np.ndarray) -> np.ndarray:
    """Paste the per-crop refined masks back (loop_UCOD_DPL.py:348-352)."""
    from PIL import Image

    new_mask = Image.fromarray((mask_hw * 255).astype(np.uint8))
    for bbox, pred in zip(bboxes, preds):
        pil = Image.fromarray((pred * 255).astype(np.uint8)).resize((bbox[2], bbox[3]))  # bicubic
        new_mask.paste(pil, (bbox[0], bbox[1]))
    return np.asarray(new_mask, dtype=np.float32) / 255.0


def refine_with_crops(img, bboxes, mask_hw: np.ndarray, img_size: Tuple[int, int], crop_batch_fn) -> np.ndarray:
    """Crop, re-infer and paste every bbox; all crops of an image go through
    ``crop_batch_fn`` ((N, H, W, 3) normalised crops -> (N, fh, fw) binary
    masks) in one call."""
    bboxes, crops = prepare_crops(img, bboxes, img_size)
    if not bboxes:
        return mask_hw
    return paste_refined(mask_hw, bboxes, batched_crop_infer(crops, crop_batch_fn))
