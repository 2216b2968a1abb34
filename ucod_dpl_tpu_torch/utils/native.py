"""The native host modules (``native/*.cpp``) of the port's host pipeline,
jax-free.

The port's copy of :mod:`ucod_dpl_tpu.utils.native`: each source is built
with g++ on first use into the port's own build directory
(``build/ucod_dpl_tpu_torch/native/``; the source directory ``native/`` is
only read), rebuilt when the source is newer, and loaded with ctypes.  When a
library cannot be built or loaded, its entry returns None and the caller
takes the NumPy, scipy or Pillow path, which computes the same values.

* ``metrics_kernel.cpp``: the per-image metric bundle
  (:func:`score_one_native`), the eval's default scorer
  (``utils/metrics.py``; ``UCOD_NATIVE_METRICS=0`` keeps NumPy);
* ``cc_label.cpp``: 8-connected labelling and per-component statistics
  (:func:`cc_label`, :func:`cc_stats`), opt-in through ``UCOD_NATIVE_CC=1``
  (``utils/components.py``; scipy is the default);
* ``imagepipe.cpp``: the JPEG/PNG decode (:func:`load_image_u8`), the
  PIL-exact bilinear resize (:func:`resize_u8_native`) and the threaded
  decode, resize and normalise of a batch (:func:`load_norm_batch_native`),
  all off with ``UCOD_NATIVE_IO=0``.  It links libjpeg and libpng; where
  they are missing the transforms decode and resize with Pillow.  The
  decode is used only where a one-time probe finds it byte-identical to
  Pillow's on this host (:func:`_decode_parity_ok`); where the probe fails
  the resize stays native.

These are host paths, not device paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "ucod_dpl_tpu_torch", "native")
_IMAGEPIPE_SRC = os.path.join(_SRC_DIR, "imagepipe.cpp")
_IMAGEPIPE_SO = os.path.join(_BUILD_DIR, "libimagepipe.so")
_CC_SRC = os.path.join(_SRC_DIR, "cc_label.cpp")
_CC_SO = os.path.join(_BUILD_DIR, "libcclabel.so")
_METRICS_SRC = os.path.join(_SRC_DIR, "metrics_kernel.cpp")
_METRICS_SO = os.path.join(_BUILD_DIR, "libmetrics.so")

_lock = threading.Lock()
_imagepipe_lib: Optional[ctypes.CDLL] = None
_imagepipe_tried = False
_cc_lib: Optional[ctypes.CDLL] = None
_cc_tried = False
_metrics_lib: Optional[ctypes.CDLL] = None
_metrics_tried = False


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
    """The image-pipe library with its entries declared, or None."""
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
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ip_load_u8.restype = ctypes.c_int32
        lib.ip_load_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), i32p, i32p, i32p,
        ]
        lib.ip_resize_u8.restype = ctypes.c_int32
        lib.ip_resize_u8.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.ip_load_norm_batch.restype = ctypes.c_int32
        lib.ip_load_norm_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, f32p, f32p, f32p, ctypes.c_int32,
        ]
        lib.ip_free.restype = None
        lib.ip_free.argtypes = [ctypes.c_void_p]
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


_WANT_CH = {"L": 1, "RGB": 3}

_decode_parity: Optional[bool] = None


def _decode_parity_ok() -> bool:
    """Whether the native JPEG/PNG decode is byte-identical to Pillow's on
    this host: probed once per process.

    The resize is bit-exact by construction (it reimplements Pillow's
    resampling), but the decode rests on the system libjpeg matching the
    libjpeg-turbo that Pillow bundles: another IDCT or upsampling differs
    by 1 a pixel and would change features, caches and metrics between the
    native path and Pillow's.  The probe decodes noise and gradient images
    at 4:2:0 and 4:4:4 subsampling, a grayscale JPEG and an RGB and a
    palette PNG through both, in RGB and L; any byte that differs turns the
    native decode off in this process (the resize stays on), with a log
    line."""
    global _decode_parity
    if _decode_parity is not None:
        return _decode_parity
    import tempfile

    from PIL import Image

    ok = True
    try:
        rng = np.random.default_rng(1234)
        noise = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
        grad = np.stack(
            list(np.meshgrid(np.arange(31, dtype=np.uint8) * 8, np.arange(29, dtype=np.uint8) * 8, indexing="ij"))
            + [np.full((31, 29), 128, np.uint8)],
            axis=-1,
        )
        with tempfile.TemporaryDirectory() as td:
            cases = []
            for name, arr, kw in (
                ("n75.jpg", noise, {"quality": 75}),  # 4:2:0 subsampling
                ("n95.jpg", noise, {"quality": 95}),  # 4:4:4
                ("g75.jpg", grad, {"quality": 75}),
                ("gray.jpg", noise[..., 0], {"quality": 85}),
                ("rgb.png", noise, {}),
                ("pal.png", None, {}),
            ):
                p = os.path.join(td, name)
                if arr is None:
                    Image.fromarray(noise).convert("P", palette=Image.ADAPTIVE).save(p)
                else:
                    Image.fromarray(arr).save(p, **kw)
                cases.append(p)
            for p in cases:
                for mode in ("RGB", "L"):
                    with Image.open(p) as im:
                        pil = np.asarray(im.convert(mode))
                    nat = _load_image_u8_unchecked(p, mode)
                    if nat is None or not np.array_equal(nat[..., 0] if mode == "L" else nat, pil):
                        ok = False
                        break
                if not ok:
                    break
    except Exception:
        ok = False
    if not ok:
        import logging

        logging.getLogger("ucod").warning(
            "native image decode disagrees with Pillow on this host (another system libjpeg or libpng?): the "
            "native decode is off, Pillow decodes and the native resize stays on; outputs stay bit-identical "
            "to the Pillow chain."
        )
    _decode_parity = ok
    return ok


def load_image_u8(path, mode: str = "RGB", size_hw: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
    """Decode one JPEG or PNG file, convert it to ``mode`` ("RGB" or "L")
    and, with ``size_hw``, resize it PIL-BILINEAR-exactly -> (H, W, C)
    uint8; None when the library is not available, the host fails the
    decode-parity probe, or the file's container or colour space is outside
    the native decoder's (the caller then decodes with Pillow)."""
    if get_imagepipe_lib() is None or not _decode_parity_ok():
        return None
    return _load_image_u8_unchecked(path, mode, size_hw)


def _load_image_u8_unchecked(path, mode: str = "RGB", size_hw: Optional[Tuple[int, int]] = None):
    """:func:`load_image_u8` without the parity probe (the probe's own
    decode); None on any failure."""
    lib = get_imagepipe_lib()
    if lib is None:
        return None
    dh, dw = size_hw if size_hw is not None else (0, 0)
    out = ctypes.c_void_p()
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.ip_load_u8(str(path).encode(), _WANT_CH[mode], dh, dw, ctypes.byref(out), ctypes.byref(w),
                        ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), shape=(n,))
        arr = arr.reshape(h.value, w.value, c.value).copy()
    finally:
        lib.ip_free(out)
    return arr


def load_norm_batch_native(paths, size_hw: Tuple[int, int], mean, std, mode: str = "RGB",
                           nthreads: int = 0) -> Optional[np.ndarray]:
    """Decode, resize and normalise image files into a float32 (N, H, W, C)
    array on ``nthreads`` native threads (0: one per file up to the core
    count), bit-identical to the Pillow + NumPy transform chain; None when
    the library is not available, the host fails the decode-parity probe,
    ``paths`` is empty, or any file fails (the caller then takes Pillow for
    the whole batch)."""
    lib = get_imagepipe_lib()
    if lib is None or not paths or not _decode_parity_ok():
        return None
    want = _WANT_CH[mode]
    dh, dw = size_hw
    n = len(paths)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    std = np.ascontiguousarray(std, dtype=np.float32)
    out = np.empty((n, dh, dw, want), dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.ip_load_norm_batch(c_paths, n, want, dh, dw, mean.ctypes.data_as(f32p), std.ctypes.data_as(f32p),
                                out.ctypes.data_as(f32p), nthreads)
    return None if rc != 0 else out


# ---------------------------------------------------------------------------
# connected components (native/cc_label.cpp)
# ---------------------------------------------------------------------------


def get_lib() -> Optional[ctypes.CDLL]:
    """The labeller library with its entries declared, or None."""
    global _cc_lib, _cc_tried
    with _lock:
        if _cc_lib is not None or _cc_tried:
            return _cc_lib
        _cc_tried = True
        lib = _load_so(_CC_SRC, _CC_SO)
        if lib is None:
            return None
        lib.cc_label_u8.restype = ctypes.c_int32
        lib.cc_label_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                                    ctypes.POINTER(ctypes.c_int32)]
        lib.cc_stats.restype = None
        lib.cc_stats.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.POINTER(ctypes.c_int32)]
        _cc_lib = lib
        return _cc_lib


def cc_label(mask: np.ndarray) -> Optional[Tuple[int, np.ndarray]]:
    """8-connected labelling of ``mask > 0`` -> (components, (H, W) int32
    labels, 0 the background), or None when the library is not available."""
    lib = get_lib()
    if lib is None:
        return None
    mask_u8 = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    h, w = mask_u8.shape
    labels = np.empty((h, w), dtype=np.int32)
    n = lib.cc_label_u8(mask_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return int(n), labels


def cc_stats(labels: np.ndarray, num: int) -> Optional[np.ndarray]:
    """(num, 5) int32 [area, x0, y0, x1, y1] of each component of ``labels``,
    or None when the library is not available."""
    lib = get_lib()
    if lib is None:
        return None
    if num == 0:
        return np.zeros((0, 5), np.int32)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    out = np.empty((num, 5), dtype=np.int32)
    lib.cc_stats(labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), labels.shape[0], labels.shape[1], num,
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


# ---------------------------------------------------------------------------
# the metric scorer (native/metrics_kernel.cpp)
# ---------------------------------------------------------------------------


def get_metrics_lib() -> Optional[ctypes.CDLL]:
    """The scorer library with its entry declared, or None."""
    global _metrics_lib, _metrics_tried
    with _lock:
        if _metrics_lib is not None or _metrics_tried:
            return _metrics_lib
        _metrics_tried = True
        lib = _load_so(_METRICS_SRC, _METRICS_SO)
        if lib is None:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.score_one.restype = None
        lib.score_one.argtypes = [
            dp,  # pred (normalised)
            ctypes.POINTER(ctypes.c_uint8),  # gt (bool)
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,  # pred_is_int (the constant-prediction quirk)
            dp,  # 7x7 gaussian kernel
            dp,  # scalars[5]
            dp,  # e_curve[256]
            dp,  # f_curve[256]
        ]
        _metrics_lib = lib
        return _metrics_lib


def score_one_native(pred_norm: np.ndarray, gt_bool: np.ndarray, kernel7: np.ndarray):
    """The per-image metric bundle of a protocol-normalised pair
    ``(sm, mae, wfm, acc, iou, e_curve, f_curve)``, in float64 as the NumPy
    path computes it, or None when the library is not available.

    ``pred_norm`` keeps ``normalize_pair``'s dtype: an integer array signals
    the constant-prediction quirk, where the reference's WFM convolution runs
    in integer arithmetic (scipy truncates the int64 output toward zero)."""
    lib = get_metrics_lib()
    if lib is None:
        return None
    pred_is_int = np.issubdtype(np.asarray(pred_norm).dtype, np.integer)
    pred = np.ascontiguousarray(pred_norm, dtype=np.float64)
    gt = np.ascontiguousarray(gt_bool, dtype=np.uint8)
    k = np.ascontiguousarray(kernel7, dtype=np.float64)
    h, w = pred.shape
    scalars = np.empty(5, np.float64)
    e_curve = np.empty(256, np.float64)
    f_curve = np.empty(256, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.score_one(pred.ctypes.data_as(dp), gt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                  int(pred_is_int), k.ctypes.data_as(dp), scalars.ctypes.data_as(dp), e_curve.ctypes.data_as(dp),
                  f_curve.ctypes.data_as(dp))
    return (*(float(x) for x in scalars), e_curve, f_curve)
