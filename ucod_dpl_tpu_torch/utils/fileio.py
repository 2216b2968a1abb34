"""Image reading, jax-free: the port's copy of ``ImageIO.read_image`` of
:mod:`ucod_dpl_tpu.utils.fileio`."""

from __future__ import annotations

from pathlib import Path
from typing import Union


class ImageIO:
    """Minimal Pillow-backed image reader."""

    @staticmethod
    def read_image(path: Union[str, Path], mode: str = "RGB"):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        with Image.open(path) as img:
            return img.convert(mode)
