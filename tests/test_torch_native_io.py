"""The port's native image pipeline (``ucod_dpl_tpu_torch.utils.native``:
``load_image_u8``, ``load_norm_batch_native``, the decode-parity probe) and
its path-based transforms against the JAX package's, on the same seeded
JPEG and PNG files, as tests/test_native_io.py holds the JAX ones.

The contract is bit-exactness: the native decode, the decode with the fused
resize and the threaded batch give the bytes of the Pillow + NumPy chain and
of the JAX functions, and every entry returns None in the JAX functions'
cases (an unsupported container or a missing file, ``UCOD_NATIVE_IO=0``, a
failed probe, which keeps the native resize on), where the transforms take
Pillow with the same output.
"""

import numpy as np
import pytest
from PIL import Image

from ucod_dpl_tpu.data import transforms as JT
from ucod_dpl_tpu.utils import native as JN
from ucod_dpl_tpu_torch.data import transforms as TT
from ucod_dpl_tpu_torch.utils import native as TN


@pytest.fixture(scope="module")
def lib():
    if TN.get_imagepipe_lib() is None or JN.get_imagepipe_lib() is None:
        pytest.skip("native image pipeline unavailable (no g++/libjpeg/libpng?)")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """One file per supported container and colour space (the JAX test's)."""
    td = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (211, 317, 3), dtype=np.uint8)
    rgba = np.concatenate([a, rng.integers(0, 256, (211, 317, 1), dtype=np.uint8)], axis=-1)
    files = {}
    for img, name, kw in ((Image.fromarray(a), "rgb.jpg", {"quality": 92}),
                          (Image.fromarray(a).convert("L"), "gray.jpg", {"quality": 92}),
                          (Image.fromarray(a), "rgb.png", {}),
                          (Image.fromarray(a).convert("L"), "gray.png", {}),
                          (Image.fromarray(a).convert("P", palette=Image.ADAPTIVE), "palette.png", {}),
                          (Image.fromarray(rgba, "RGBA"), "rgba.png", {}),
                          (Image.fromarray(a).convert("1"), "onebit.png", {})):
        img.save(td / name, **kw)
        files[name] = td / name
    return files


def _pil_image(path, size_hw):
    with Image.open(path) as im:
        im = im.convert("RGB")
        if size_hw is not None:
            im = im.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
        arr = np.asarray(im, np.float32) / 255.0
    return ((arr - TT.IMAGENET_MEAN) / TT.IMAGENET_STD).astype(np.float32)


def test_decode_parity_probe_passes_here(lib):
    assert TN._decode_parity_ok() is True and JN._decode_parity_ok() is True


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_decode_is_bit_exact_with_pillow_and_jax(lib, image_files, mode):
    for name, path in image_files.items():
        with Image.open(path) as im:
            pil = np.asarray(im.convert(mode))
        got = TN.load_image_u8(path, mode)
        assert got is not None and got.dtype == np.uint8 and got.ndim == 3, name
        np.testing.assert_array_equal(got, JN.load_image_u8(path, mode), err_msg=name)
        np.testing.assert_array_equal(got[..., 0] if mode == "L" else got, pil, err_msg=name)


@pytest.mark.parametrize("name,mode,size", [("rgb.jpg", "RGB", (64, 96)), ("rgb.png", "RGB", (300, 41)),
                                            ("gray.png", "L", (37, 91)), ("rgba.png", "RGB", (518, 518))])
def test_decode_with_fused_resize_is_bit_exact(lib, image_files, name, mode, size):
    path = image_files[name]
    with Image.open(path) as im:
        pil = np.asarray(im.convert(mode).resize((size[1], size[0]), Image.BILINEAR))
    got = TN.load_image_u8(path, mode, size_hw=size)
    np.testing.assert_array_equal(got, JN.load_image_u8(path, mode, size_hw=size))
    np.testing.assert_array_equal(got[..., 0] if mode == "L" else got, pil)


@pytest.mark.parametrize("nthreads", [1, 4])
def test_batch_is_bit_exact_with_the_pillow_chain_and_jax(lib, image_files, nthreads):
    paths = sorted(image_files.values())
    got = TN.load_norm_batch_native(paths, (64, 96), TT.IMAGENET_MEAN, TT.IMAGENET_STD, nthreads=nthreads)
    want = np.stack([_pil_image(p, (64, 96)) for p in paths])
    assert got.shape == (len(paths), 64, 96, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, JN.load_norm_batch_native(paths, (64, 96), JT.IMAGENET_MEAN,
                                                                 JT.IMAGENET_STD, nthreads=nthreads))
    np.testing.assert_array_equal(TT.load_image_batch_transform(paths, (64, 96), nthreads=nthreads), want)


def test_none_for_an_unsupported_container_a_missing_file_and_a_corrupt_batch(lib, tmp_path):
    bmp = tmp_path / "img.bmp"  # outside the native contract
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(bmp)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8not a real jpeg")
    good = tmp_path / "good.jpg"
    Image.fromarray(np.full((8, 8, 3), 9, np.uint8)).save(good, quality=90)
    for native in (TN, JN):
        assert native.load_image_u8(bmp, "RGB") is None
        assert native.load_image_u8(tmp_path / "missing.jpg", "RGB") is None
        assert native.load_norm_batch_native([good, bad], (16, 16), TT.IMAGENET_MEAN, TT.IMAGENET_STD,
                                             nthreads=2) is None
        assert native.load_norm_batch_native([], (16, 16), TT.IMAGENET_MEAN, TT.IMAGENET_STD) is None
    # the transforms take Pillow for the whole batch: the same bytes
    paths = [good, bmp]
    want = np.stack([_pil_image(p, (16, 16)) for p in paths])
    np.testing.assert_array_equal(TT.load_image_batch_transform(paths, (16, 16)), want)
    np.testing.assert_array_equal(JT.load_image_batch_transform(paths, (16, 16)), want)


def test_env_gate_returns_none_on_both(lib, image_files, monkeypatch):
    """``UCOD_NATIVE_IO=0`` at the library's first use keeps it unloaded:
    every entry returns None, as the JAX package's does."""
    monkeypatch.setenv("UCOD_NATIVE_IO", "0")
    for native in (TN, JN):
        monkeypatch.setattr(native, "_imagepipe_lib", None)
        monkeypatch.setattr(native, "_imagepipe_tried", False)
        assert native.get_imagepipe_lib() is None
        assert native.load_image_u8(image_files["rgb.jpg"], "RGB") is None
        assert native.load_norm_batch_native([image_files["rgb.jpg"]], (16, 16), TT.IMAGENET_MEAN,
                                             TT.IMAGENET_STD) is None
        assert native.resize_u8_native(np.zeros((8, 8), np.uint8), (4, 4)) is None
    got = TT.load_image_transform(image_files["rgb.jpg"], (32, 32))
    np.testing.assert_array_equal(got, _pil_image(image_files["rgb.jpg"], (32, 32)))
    np.testing.assert_array_equal(got, JT.load_image_transform(image_files["rgb.jpg"], (32, 32)))


def test_failed_probe_turns_the_decode_off_and_keeps_the_resize(lib, image_files, monkeypatch):
    for native in (TN, JN):
        monkeypatch.setattr(native, "_decode_parity", False)
        assert native.load_image_u8(image_files["rgb.jpg"], "RGB") is None
        assert native.load_norm_batch_native([image_files["rgb.jpg"]], (16, 16), TT.IMAGENET_MEAN,
                                             TT.IMAGENET_STD) is None
        assert native.resize_u8_native(np.arange(64, dtype=np.uint8).reshape(8, 8), (4, 4)) is not None
    path = image_files["rgb.jpg"]
    got = TT.load_image_transform(path, (32, 32))
    np.testing.assert_array_equal(got, _pil_image(path, (32, 32)))
    np.testing.assert_array_equal(got, JT.load_image_transform(path, (32, 32)))


def test_probe_fails_when_the_native_decode_differs(lib, monkeypatch):
    """A decode one value off on one file turns the native decode off."""
    real = TN._load_image_u8_unchecked

    def off_by_one(path, mode="RGB", size_hw=None):
        arr = real(path, mode, size_hw)
        if str(path).endswith("n95.jpg"):
            arr = arr.copy()
            arr[0, 0, 0] ^= 1
        return arr

    monkeypatch.setattr(TN, "_decode_parity", None)
    monkeypatch.setattr(TN, "_load_image_u8_unchecked", off_by_one)
    assert TN._decode_parity_ok() is False


@pytest.mark.parametrize("size", [(96, 128), None])
def test_load_image_transform_matches_jax(lib, image_files, size):
    for name, path in image_files.items():
        got = TT.load_image_transform(path, size)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, JT.load_image_transform(path, size), err_msg=name)
        np.testing.assert_array_equal(got, _pil_image(path, size), err_msg=name)


@pytest.mark.parametrize("keep_size", [False, True])
def test_load_label_transform_matches_jax(lib, image_files, keep_size):
    for name in ("gray.png", "gray.jpg", "rgb.png"):
        path = image_files[name]
        got = TT.load_label_transform(path, (64, 96), keep_size=keep_size)
        with Image.open(path) as im:
            im = im.convert("L")
            if not keep_size:
                im = im.resize((96, 64), Image.BILINEAR)
            want = (np.asarray(im, np.float32) / 255.0)[..., None]
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, JT.load_label_transform(path, (64, 96), keep_size=keep_size))


def test_load_image_batch_transform_matches_jax(lib, image_files):
    paths = sorted(image_files.values())
    for size in ((64, 96), (518, 518)):
        np.testing.assert_array_equal(TT.load_image_batch_transform(paths, size),
                                      JT.load_image_batch_transform(paths, size))
