"""The entry points' host staging (``utils/staging.py``): ``Predictor.predict``
and ``FeatureExtractor.extract`` send each batch and bring each result
through host buffers they keep and reuse.

On the CPU, at a small width:

* ``predict`` (soft and hard, with and without ``output_size``, with
  LookTwice) and ``extract`` equal, bit for bit, the path that allocates
  fresh host arrays each call (written out here);
* a reused bucket never sends the last call's images (16 images, then 3);
* no returned array aliases another call's or a staging buffer;
* a non-finite value still raises ``FloatingPointError`` with the count;
* two threads share one Predictor and one extractor;
* a buffer grows to the largest request and stays one a role;
* ``entry.fill`` / ``entry.upload`` and ``entry.download`` carry ``staged``
  and ``grew``.

Marked ``cuda`` (skip without a card): the buffers are pinned, the
extraction downloads bf16 (``bytes`` = ``numel * 2``), and both entries
equal the pageable path bit for bit at dinov2-base's full size, 518px bs16
and 756px bs8.  On a card (this file imports no JAX)::

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_entry_staging.py
"""

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.data import feature_extractor
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.engine.eval_loop import find_refine_bboxes, refine_with_crops
from ucod_dpl_tpu_torch.models.dba import fg_logits_live, init_rev_decoder
from ucod_dpl_tpu_torch.models.dino import dino_forward
from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear_nhwc, interpolate_bilinear_np
from ucod_dpl_tpu_torch.serving import Predictor
from ucod_dpl_tpu_torch.utils import profiling
from ucod_dpl_tpu_torch.utils.profiling import annotate
from ucod_dpl_tpu_torch.utils.staging import Staging

DIM, SIZE = 64, 56


def _fe_cfg(dim=DIM, layers=2, heads=4, size=SIZE):
    return CfgNode({
        "type": "dinov2",
        "backbone": "facebook/dinov2-base",
        "backbone_weights": "none",
        "arch": {"hidden_size": dim, "num_layers": layers, "num_heads": heads, "patch_size": 14, "image_size": size},
    })


@pytest.fixture(scope="module")
def extractor():
    return FeatureExtractor(_fe_cfg(), device="cpu")


def _predictor(fe, max_batch=4, size=SIZE, feature_size=8):
    return Predictor(fe, init_rev_decoder(0, fe.config.hidden_size), image_size=(size, size),
                     feature_size=feature_size, max_batch=max_batch)


def _images(n, seed=0, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _uint8_images(n, seed=0, hw=(64, 72)):
    rng = np.random.default_rng(seed)
    return [(rng.random((*hw, 3)) * 255).astype(np.uint8) for _ in range(n)]


def fresh_predict(p, inputs, soft=False, output_size=None, look_twice=False):
    """``Predictor.predict`` as it was before staging: a fresh zeroed bucket
    a chunk, a pageable upload and download, a copy a mask."""
    masks = []
    for i in range(0, len(inputs), p.max_batch):
        loaded = [p._load(x) for x in inputs[i:i + p.max_batch]]
        batch = np.zeros((p._bucket(len(loaded)), *p.image_size, 3), np.float32)
        for j, (a, _) in enumerate(loaded):
            batch[j] = a
        with torch.inference_mode():
            fg, _, _ = fg_logits_live(p.fe.params, p.decoder_params, torch.from_numpy(batch).to(p.device),
                                      p.fe.config, compute_dtype=p.fe.compute_dtype, size=p.feature_size,
                                      quant=p._qparams)
            probs = torch.sigmoid(interpolate_bilinear_nhwc(fg, p.image_size)[..., 0])
            first = (probs if soft else (probs > 0.5).to(torch.uint8)).cpu().numpy()
        chunk = [m.astype(np.float32) for m in first[:len(loaded)]]
        if look_twice:
            for k, (mask, (_, img)) in enumerate(zip(chunk, loaded)):
                bboxes = find_refine_bboxes(mask, p.image_size, p.look_twice_th, p.expand_type)
                if bboxes is not None:
                    chunk[k] = refine_with_crops(img, bboxes, mask, p.image_size, p._crop_pass)
        masks.extend(chunk)
    if output_size is not None:
        masks = [interpolate_bilinear_np(m, output_size) for m in masks]
        if not soft:
            masks = [(m > 0.5).astype(np.float32) for m in masks]
    return masks


def fresh_extract(fe, images):
    """``FeatureExtractor.extract`` as it was before staging (one device):
    a pageable upload, the features cast to float32 on the device and
    downloaded into fresh pages."""
    with torch.inference_mode():
        out = dino_forward(fe.params, torch.from_numpy(images).to(fe.device), fe.config,
                           compute_dtype=fe.compute_dtype)
        return out["key_features"].float().cpu().numpy()


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _sizes(staging):
    return {key: buf.nbytes() for key, buf in staging._buffers.items()}


def _buffer_views(staging):
    return [torch.empty(0, dtype=torch.uint8).set_(buf, 0, (buf.nbytes(),)).numpy()
            for buf in staging._buffers.values()]


@contextlib.contextmanager
def _recorded():
    """A CPU profiler session -> the spans recorded in it."""
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("warm"):
            pass
        t0 = max((s.end for s in profiling.spans()), default=0)
        yield got
    got.extend(s for s in profiling.spans() if s.start > t0)


@pytest.mark.parametrize("soft,output_size", [(True, None), (False, None), (True, (30, 40)), (False, (30, 40))])
def test_predict_equals_the_fresh_path(extractor, soft, output_size):
    p = _predictor(extractor)
    images = list(_images(6, seed=1))  # chunks of 4 and 2
    for _ in range(2):  # the second call on reused buffers
        _assert_bitwise(p.predict(images, soft=soft, output_size=output_size),
                        fresh_predict(p, images, soft=soft, output_size=output_size))


def test_predict_look_twice_equals_the_fresh_path(extractor):
    p = _predictor(extractor)
    p.look_twice_th = 0.95  # force the zoom-in pass
    images = _uint8_images(3, seed=4, hw=(90, 110))
    want = fresh_predict(p, images, look_twice=True)
    assert any(not np.array_equal(w, m) for w, m in zip(want, fresh_predict(p, images)))  # LookTwice changed a mask
    for _ in range(2):
        _assert_bitwise(p.predict(images, look_twice=True), want)


def test_extract_equals_the_fresh_path(extractor):
    for n in (3, 1, 3):
        images = _images(n, seed=n)
        _assert_bitwise(extractor.extract(images), fresh_extract(extractor, images))


def test_extract_with_attention_equals_its_unstaged_outputs(extractor):
    images = _images(2, seed=5)
    got = extractor.extract_with_attention(images)
    with torch.inference_mode():
        out = dino_forward(extractor.params, torch.from_numpy(images), extractor.config,
                           compute_dtype=extractor.compute_dtype, want_cls_attention=True)
    want = [out[k].float().numpy() for k in ("key_tokens", "key_features", "cls_attention")]
    _assert_bitwise(got, want)


def test_padded_rows_are_zeroed_after_a_full_bucket(extractor):
    """16 images, then 3: the 3 masks equal a fresh Predictor's, so rows 3-15
    of the reused bucket held zeros and not the first call's images."""
    images = _images(16, seed=2)
    p = _predictor(extractor, max_batch=16)
    p.predict(list(images), soft=True)
    got = p.predict(list(images[:3]), soft=True)
    _assert_bitwise(got, _predictor(extractor, max_batch=16).predict(list(images[:3]), soft=True))
    _assert_bitwise(got, fresh_predict(p, list(images[:3]), soft=True))


@pytest.mark.parametrize("entry", ["predict", "predict_hard", "extract"])
def test_outputs_alias_no_other_call_and_no_buffer(extractor, entry):
    if entry == "extract":
        fe = FeatureExtractor(_fe_cfg(), device="cpu")
        call, staging = (lambda x: [fe.extract(x)]), fe._staging
    else:
        p = _predictor(extractor)
        call, staging = (lambda x: p.predict(list(x), soft=entry == "predict")), p._staging
    first = call(_images(3, seed=6))
    kept = [a.copy() for a in first]
    second = call(_images(3, seed=7))
    _assert_bitwise(first, kept)  # unchanged by the second call
    assert not any(np.array_equal(a, b) for a, b in zip(first, second))
    for a in first + second:
        assert not any(np.shares_memory(a, view) for view in _buffer_views(staging))
    for a in first:
        assert not any(np.shares_memory(a, b) for b in second)


def _plant_nan(monkeypatch, n):
    def planted(*args, **kwargs):
        out = dino_forward(*args, **kwargs)
        out["key_features"][0, 0, 0, :n] = float("nan")
        return out

    monkeypatch.setattr(feature_extractor, "dino_forward", planted)


def test_non_finite_features_raise_with_the_count(monkeypatch):
    fe = FeatureExtractor(_fe_cfg(), device="cpu")
    fe.extract(_images(2))  # buffers in place: the check runs on the reused path too
    _plant_nan(monkeypatch, 3)
    size = 2 * (SIZE // 14) ** 2 * DIM
    with pytest.raises(FloatingPointError, match=rf"non-finite features \(3/{size} bad\) on cpu"):
        fe.extract(_images(2))


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")])
def test_to_host_f32_counts_each_non_finite_value(value):
    t = torch.zeros(2, 5, 7, dtype=torch.bfloat16)
    t[1, 2, :4] = value
    staging, out = Staging(), np.empty((2, 5, 7), np.float32)
    with pytest.raises(FloatingPointError, match=r"non-finite CLS attention \(4/70 bad\)"):
        FeatureExtractor._to_host_f32(t, "CLS attention", out, staging)
    t[1] = 1.5
    assert FeatureExtractor._to_host_f32(t, "CLS attention", out, staging) is out
    np.testing.assert_array_equal(out, t.float().numpy())


def _hammer(calls, threads=4, rounds=3):
    """Run each of ``calls`` (-> its check) from its own thread, ``rounds``
    times, with a short switch interval; every check must hold."""
    errors, interval = [], sys.getswitchinterval()

    def worker(call):
        try:
            for _ in range(rounds):
                call()
        except Exception as e:  # noqa: BLE001 -- reported below with the others
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker, args=(calls[k % len(calls)],)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors


def test_threads_share_one_predictor(extractor):
    p = _predictor(extractor)
    inputs = [list(_images(n, seed=10 + n)) for n in (3, 5)]
    want = [fresh_predict(p, x, soft=True) for x in inputs]

    def caller(k):
        def call():
            _assert_bitwise(p.predict(inputs[k], soft=True), want[k])
        return call

    _hammer([caller(0), caller(1)])


def test_threads_share_one_extractor():
    fe = FeatureExtractor(_fe_cfg(), device="cpu")
    inputs = [_images(n, seed=20 + n) for n in (2, 3)]
    want = [fresh_extract(fe, x) for x in inputs]

    def caller(k):
        def call():
            np.testing.assert_array_equal(fe.extract(inputs[k]), want[k])
        return call

    _hammer([caller(0), caller(1)])


def test_buffers_grow_to_the_largest_request_one_a_role(extractor):
    p = _predictor(extractor)
    for n in (1, 4, 2, 3):
        p.predict(list(_images(n)), soft=True)
    cpu = torch.device("cpu")
    assert _sizes(p._staging) == {("input", cpu): 4 * SIZE * SIZE * 3 * 4, ("result", cpu): 4 * SIZE * SIZE * 4}
    p.predict(list(_images(2)), soft=False)  # uint8 masks fit the float32 result buffer
    assert _sizes(p._staging)[("result", cpu)] == 4 * SIZE * SIZE * 4

    fe = FeatureExtractor(_fe_cfg(), device="cpu")
    for n, size in ((1, SIZE), (3, SIZE), (2, 84), (1, 28)):  # the shapes of RefinePredictor's resolutions
        fe.extract(_images(n, size=size))
    assert _sizes(fe._staging) == {("input", cpu): 2 * 84 * 84 * 3 * 4,
                                    ("result", cpu): 2 * (84 // 14) ** 2 * DIM * 4}


def test_spans_count_staged_and_grew(extractor):
    p = _predictor(extractor)
    fe = FeatureExtractor(_fe_cfg(), device="cpu")
    with _recorded() as got:
        p.predict(list(_images(2)), soft=True)  # bucket 2: allocated
        p.predict(list(_images(2)), soft=True)  # reused
        p.predict(list(_images(4)), soft=True)  # bucket 4: grown
        fe.extract(_images(2))
        fe.extract(_images(1))
    counts = {}
    for s in got:
        if "staged" in s.attrs:
            counts.setdefault(s.name, []).append((s.attrs["staged"], s.attrs["grew"]))
    assert counts == {"entry.fill": [(0, 1), (1, 0), (0, 1)],
                      "entry.download": [(0, 1), (1, 0), (0, 1), (0, 1), (1, 0)],
                      "entry.upload": [(0, 1), (1, 0)]}


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def base_extractor(card):
    """dinov2-base at its full width, random weights, bf16 on the card."""
    cfg = CfgNode({"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": "none"})
    return FeatureExtractor(cfg, device=card, strict=False)


@pytest.mark.cuda
def test_card_buffers_are_pinned(base_extractor):
    p = _predictor(base_extractor, max_batch=2, size=518, feature_size=68)
    p.predict(list(_images(2, size=518)), soft=True)
    base_extractor.extract(_images(1, size=518))
    for staging in (p._staging, base_extractor._staging):
        assert len(staging._buffers) == 2
        for (role, device), buf in staging._buffers.items():
            view = torch.empty(0, dtype=torch.uint8).set_(buf, 0, (buf.nbytes(),))
            assert device.type == "cuda" and view.is_pinned(), role


@pytest.mark.cuda
def test_card_extraction_downloads_bf16(base_extractor):
    images = _images(2, size=518)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with annotate("warm"):
            pass
        t0 = max((s.end for s in profiling.spans()), default=0)
        feats = base_extractor.extract(images)
    got = [s for s in profiling.spans() if s.start > t0]
    (down,) = [s for s in got if s.name == "entry.download"]
    (up,) = [s for s in got if s.name == "entry.upload"]
    assert feats.dtype == np.float32 and down.attrs["bytes"] == feats.size * 2 and up.attrs["bytes"] == images.nbytes
    assert base_extractor.compute_dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [True, False])
def test_card_predict_518_bs16_equals_the_pageable_path(base_extractor, soft):
    p = _predictor(base_extractor, max_batch=16, size=518, feature_size=68)
    images = list(_images(16, seed=3, size=518))
    want = fresh_predict(p, images, soft=soft)
    for _ in range(2):
        _assert_bitwise(p.predict(images, soft=soft), want)
    _assert_bitwise(p.predict(images[:3], soft=soft), want[:3])


@pytest.mark.cuda
def test_card_extract_756_bs8_equals_the_pageable_path(base_extractor):
    for seed in (4, 5):
        images = _images(8, seed=seed, size=756)
        _assert_bitwise(base_extractor.extract(images), fresh_extract(base_extractor, images))
