"""The native image resize (``native/imagepipe.cpp``) for the port's host
pipeline, jax-free.

The port's copy of the image-pipe part of :mod:`ucod_dpl_tpu.utils.native`:
``imagepipe.cpp`` is built with g++ on first use into the port's own build
directory (``build/ucod_dpl_tpu_torch/native/``; the source directory
``native/`` is only read), rebuilt when the source is newer, and loaded with
ctypes.  When it cannot be built or loaded, or ``UCOD_NATIVE_IO=0``,
:func:`resize_u8_native` returns None and the caller resizes with Pillow,
whose BILINEAR filter the native resize reproduces bit for bit.  This is the
host's image decode path, not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_IMAGEPIPE_SRC = os.path.join(_REPO_ROOT, "native", "imagepipe.cpp")
_IMAGEPIPE_SO = os.path.join(_REPO_ROOT, "build", "ucod_dpl_tpu_torch", "native", "libimagepipe.so")

_lock = threading.Lock()
_imagepipe_lib: Optional[ctypes.CDLL] = None
_imagepipe_tried = False


def _build_so(src: str, so: str, ldflags: Tuple[str, ...] = ()) -> bool:
    """Build to a private temp file, then ``os.replace`` (atomic): processes
    that build at the same time never load a half-written library."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.build.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, src] + list(ldflags),
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load_so(src: str, so: str, ldflags: Tuple[str, ...] = ()) -> Optional[ctypes.CDLL]:
    """(Re)build when the source is newer than the library, then dlopen;
    None on any failure."""
    if not os.path.exists(so) or (os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)):
        if not os.path.exists(src) or not _build_so(src, so, ldflags):
            return None
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


def get_imagepipe_lib() -> Optional[ctypes.CDLL]:
    """The image-pipe library with the resize entry declared, or None."""
    global _imagepipe_lib, _imagepipe_tried
    with _lock:
        if _imagepipe_lib is not None or _imagepipe_tried:
            return _imagepipe_lib
        _imagepipe_tried = True
        if os.environ.get("UCOD_NATIVE_IO", "1") == "0":
            return None
        lib = _load_so(_IMAGEPIPE_SRC, _IMAGEPIPE_SO, ldflags=("-ljpeg", "-lpng"))
        if lib is None:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ip_resize_u8.restype = ctypes.c_int32
        lib.ip_resize_u8.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int32, ctypes.c_int32,
        ]
        _imagepipe_lib = lib
        return _imagepipe_lib


def resize_u8_native(arr: np.ndarray, size_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """PIL.Image.BILINEAR-exact resize of an (H, W[, C]) uint8 array, or None
    when the library is not available."""
    lib = get_imagepipe_lib()
    if lib is None:
        return None
    squeeze = arr.ndim == 2
    src = np.ascontiguousarray(arr[..., None] if squeeze else arr, dtype=np.uint8)
    sh, sw, c = src.shape
    dh, dw = size_hw
    dst = np.empty((dh, dw, c), dtype=np.uint8)
    rc = lib.ip_resize_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), sh, sw, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dh, dw,
    )
    if rc != 0:
        return None
    return dst[..., 0] if squeeze else dst
