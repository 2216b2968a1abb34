"""Sample-per-file array caches, image listing, reading and mask writing,
jax-free.

The port's copy of :mod:`ucod_dpl_tpu.utils.fileio`, which keeps the
on-disk contract of the reference's ``MetaListPickleIO``
(``engine/utils/fileio/backend/ioctl/pickleio.py:54-142``): a directory of
one ``.npy`` file per sample and an ``index.json`` mapping ``str(index) ->
filename``, written last and atomically, with a ``cache_meta.json`` identity
sidecar beside it.  Caches written by the JAX package, by the reference and
by the port are interchangeable; read mode also takes the reference's legacy
``.pkl`` samples.  Pillow is imported only to read an image or write a mask.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


class JSONIO:
    @staticmethod
    def read_file(path: Union[str, Path]) -> Any:
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def write_file(path: Union[str, Path], obj: Any) -> None:
        """Write through a temporary file and ``os.replace``: ``index.json``
        is the build-complete signal, so no reader may see half of it."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)


def _to_numpy(obj: Any) -> np.ndarray:
    """A cache payload (numpy array or torch tensor) as a numpy array."""
    if isinstance(obj, np.ndarray):
        return obj
    if hasattr(obj, "detach"):  # a torch tensor from a legacy pickle cache
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


class ArrayCache:
    """Directory-backed array store, ``{base}/data_{i}.npy`` + ``index.json``.

    ``mode`` is decided by an integrity check on open: ``"r"`` when the
    manifest exists and every file it names is present, else ``"w"``."""

    def __init__(self, base_path: Union[str, Path], file_prefix: str = "data", logger=None):
        self.base_path = Path(base_path)
        self.index_path = self.base_path / "index.json"
        self.file_prefix = file_prefix
        self.logger = logger
        self.index_map: Dict[str, Path] = {}
        ok, why = self.check_integrity(self.index_path)
        self.mode = "r" if ok else "w"
        if self.mode == "r":
            self._prepare_reading()
        elif self.logger is not None:
            self.logger.log(f"Cache at {self.base_path} not available ({why}); write mode")

    @staticmethod
    def check_integrity(index_path: Union[str, Path]):
        index_path = Path(index_path)
        if not index_path.exists():
            return False, "index file missing"
        try:
            index_map = JSONIO.read_file(index_path)
        except (json.JSONDecodeError, OSError):
            return False, "index file unreadable"
        for idx, fname in index_map.items():
            if not (index_path.parent / fname).exists():
                return False, f"missing sample file for index {idx}"
        return True, ""

    def _prepare_reading(self) -> None:
        raw = JSONIO.read_file(self.index_path)
        self.index_map = {k: self.base_path / v for k, v in raw.items()}

    def __len__(self) -> int:
        return len(self.index_map)

    def read(self, index: int) -> np.ndarray:
        if self.mode != "r":
            raise RuntimeError(f"Cache {self.base_path} is not in read mode")
        path = self.index_map[str(index)]
        if path.suffix == ".npy":
            return np.load(path)
        if path.suffix == ".pkl":  # legacy reference cache (torch pickle)
            import pickle

            with open(path, "rb") as f:
                return _to_numpy(pickle.load(f))
        raise ValueError(f"Unknown cache file type: {path}")

    def write(self, index: int, array: np.ndarray) -> None:
        if self.mode != "w":
            raise RuntimeError(f"Cache {self.base_path} is not in write mode")
        self.base_path.mkdir(parents=True, exist_ok=True)
        fname = f"{self.file_prefix}_{index}.npy"
        np.save(self.base_path / fname, _to_numpy(array))
        self.index_map[str(index)] = fname  # type: ignore[assignment]

    def dump_list(self, arrays: Sequence[np.ndarray]) -> None:
        """Write ``arrays`` as entries 0, 1, ... and flush the index."""
        for i, arr in enumerate(arrays):
            self.write(i, arr)
        self.flush()

    def flush(self, meta: Optional[Dict[str, Any]] = None) -> None:
        """Write the identity sidecar ``meta`` (if given), then the index:
        a crash between the two leaves no index, so the cache rebuilds."""
        if meta is not None:
            JSONIO.write_file(self.base_path / "cache_meta.json", meta)
        JSONIO.write_file(
            self.index_path,
            {k: (v if isinstance(v, str) else Path(v).name) for k, v in self.index_map.items()},
        )
        self._prepare_reading()
        self.mode = "r"

    def read_meta(self) -> Optional[Dict[str, Any]]:
        """The identity sidecar, or None for legacy and reference caches."""
        p = self.base_path / "cache_meta.json"
        if not p.exists():
            return None
        try:
            return JSONIO.read_file(p)
        except (json.JSONDecodeError, OSError):
            return None

    def invalidate(self, reason: str) -> None:
        """Drop the manifest and the sidecar and enter write mode (the
        rebuild overwrites the sample files)."""
        if self.logger is not None:
            self.logger.log(f"Invalidating cache at {self.base_path}: {reason}")
        for name in ("index.json", "cache_meta.json"):
            p = self.base_path / name
            if p.exists():
                p.unlink()
        self.index_map = {}
        self.mode = "w"


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


class ImageIO:
    """Pillow-backed image reading and directory listing."""

    @staticmethod
    def read_image(path: Union[str, Path], mode: str = "RGB"):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        with Image.open(path) as img:
            return img.convert(mode)

    @staticmethod
    def list_dir_image(directory: Union[str, Path]) -> List[Path]:
        directory = Path(directory)
        if not directory.exists():
            return []
        return sorted(p for p in directory.iterdir() if p.suffix.lower() in _IMAGE_EXTS)


def save_binary_mask(mask: np.ndarray, save_path: Union[str, Path]) -> None:
    """Save a {0, 1} or bool mask as an 8-bit grayscale PNG; a ``.jpg`` name
    becomes ``.png``, as the reference does (``engine/utils/save_image.py``)."""
    from PIL import Image

    mask = np.squeeze(np.asarray(mask))
    save_path = str(save_path)
    if save_path.endswith(".jpg"):
        save_path = save_path[:-4] + ".png"
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    Image.fromarray((mask * 255).astype(np.uint8), mode="L").save(save_path)
