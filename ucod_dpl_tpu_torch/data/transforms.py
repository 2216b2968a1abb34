"""Host-side image preprocessing (NHWC numpy), jax-free.

Counterpart of :mod:`ucod_dpl_tpu.data.transforms` (the reference's
torchvision pipelines, ``data/datasets/transforms.py:8-43``): Pillow-BILINEAR
resize, scale to [0, 1], ImageNet normalisation.  The path-based loaders
decode, resize and normalise through the repository's native image pipe
(``ucod_dpl_tpu_torch.utils.native``: its resize is bit-exact with Pillow's
by construction, its decode is used only where a one-time probe finds it
byte-identical to Pillow's on this host), and take Pillow where the pipe
does not build, the probe fails, ``UCOD_NATIVE_IO=0`` is set or a file is
outside the native decoder's containers; every path gives the same bytes.
Pillow is imported only when it is needed.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ucod_dpl_tpu_torch.utils import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def resize_bilinear(img, size_hw: Tuple[int, int]) -> np.ndarray:
    """Pillow-BILINEAR resize of a PIL image or uint8 HW[C] array -> uint8
    array.  Palette and bilevel images stay on Pillow, which resamples those
    modes with NEAREST whatever filter is asked for."""
    from PIL import Image

    h, w = size_hw
    if isinstance(img, Image.Image) and img.mode not in ("L", "RGB", "RGBA"):
        return np.asarray(img.resize((w, h), Image.BILINEAR))
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        out = native.resize_u8_native(arr, size_hw)
        if out is not None:
            return out
    if not isinstance(img, Image.Image):
        img = Image.fromarray(img)
    return np.asarray(img.resize((w, h), Image.BILINEAR))


def to_array(img) -> np.ndarray:
    """ToTensor equivalent: HWC float32 in [0, 1]."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr[:, :, None] if arr.ndim == 2 else arr


def image_transform(img, size_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """Resize (optional) + ToTensor + ImageNet-normalise -> (H, W, 3) float32."""
    if size_hw is not None:
        img = resize_bilinear(img, size_hw)
    return (to_array(img) - IMAGENET_MEAN) / IMAGENET_STD


def label_transform(img, size_hw: Tuple[int, int], keep_size: bool = False) -> np.ndarray:
    """Grayscale label -> (H, W, 1) float32 in [0, 1]; resized unless
    ``keep_size``."""
    if not keep_size:
        img = resize_bilinear(img, size_hw)
    return to_array(img)


def patch_transform(img) -> np.ndarray:
    """ToTensor + normalise without resizing (the LR patch pipeline): the
    JAX ``patch_transform``."""
    return image_transform(img, None)


# Path-based loaders: the native decode + resize + normalise, Pillow where it
# is not available.


def _pil_load_image(path, size_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    from ucod_dpl_tpu_torch.utils.fileio import ImageIO

    return image_transform(ImageIO.read_image(path, "RGB"), size_hw)


def load_image_transform(path, size_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """Decode + resize + normalise one image file -> (H, W, 3) float32: the
    native decode with the fused resize when a size is given, else (or
    where it returns None) Pillow."""
    if size_hw is not None:
        arr = native.load_image_u8(path, "RGB", size_hw)
        if arr is not None:
            return (to_array(arr) - IMAGENET_MEAN) / IMAGENET_STD
    return _pil_load_image(path, size_hw)


def load_image_batch_transform(paths: Sequence, size_hw: Tuple[int, int], nthreads: int = 0) -> np.ndarray:
    """Decode + resize + normalise image files -> (N, H, W, 3) float32: one
    native call on ``nthreads`` threads (0: one per file up to the core
    count); where it returns None, Pillow per image, one thread per file up
    to the core count (Pillow's decode and the native resize release the
    GIL)."""
    paths = list(paths)
    out = native.load_norm_batch_native(paths, size_hw, IMAGENET_MEAN, IMAGENET_STD, nthreads=nthreads)
    if out is not None:
        return out
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, min(len(paths), os.cpu_count() or 1))) as pool:
        return np.stack(list(pool.map(lambda p: _pil_load_image(p, size_hw), paths)))


def load_label_transform(path, size_hw: Tuple[int, int], keep_size: bool = False) -> np.ndarray:
    """Decode a grayscale label file -> (H, W, 1) float32 in [0, 1]: the
    native decode (resized unless ``keep_size``), else Pillow."""
    arr = native.load_image_u8(path, "L", None if keep_size else size_hw)
    if arr is not None:
        return to_array(arr)
    from ucod_dpl_tpu_torch.utils.fileio import ImageIO

    return label_transform(ImageIO.read_image(path, "L"), size_hw, keep_size=keep_size)
