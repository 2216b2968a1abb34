"""The port's Predictor on the CPU against the JAX Predictor.

Mirrors tests/test_serving.py (buckets, batch invariance, soft masks,
output_size, LookTwice, input handling, strict weights) with the JAX
``Predictor`` as the oracle: both serve the same weights (the JAX extractor's
random init carried across by ``ucod_dpl_tpu_torch.models.convert``) on the
same inputs.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from ucod_dpl_tpu.config import CfgNode
from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor as JaxExtractor
from ucod_dpl_tpu.models.dba import init_rev_decoder
from ucod_dpl_tpu.serving import Predictor as JaxPredictor
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.models.convert import decoder_from_jax, dino_from_jax
from ucod_dpl_tpu_torch.serving import Predictor

DIM = 64


def _fe_cfg(**extra):
    return CfgNode({
        "type": "dinov2",
        "backbone": "facebook/dinov2-base",
        "backbone_weights": "none",
        "arch": {"hidden_size": DIM, "num_layers": 2, "num_heads": 4, "patch_size": 14, "image_size": 56},
        **extra,
    })


@pytest.fixture(scope="module")
def predictors():
    jfe = JaxExtractor(_fe_cfg())
    jdec = init_rev_decoder(jax.random.PRNGKey(0), DIM)
    fe = FeatureExtractor(_fe_cfg(), device="cpu")
    fe.params = dino_from_jax(jax.tree_util.tree_map(np.asarray, jfe.params))
    kw = dict(image_size=(56, 56), feature_size=8, max_batch=4)
    port = Predictor(fe, decoder_from_jax(jax.tree_util.tree_map(np.asarray, jdec)), **kw)
    return port, JaxPredictor(jfe, jdec, **kw)


def _images(seed, n, hw=(64, 72)):
    rng = np.random.default_rng(seed)
    return [(rng.random((*hw, 3)) * 255).astype(np.uint8) for _ in range(n)]


def _assert_masks_match(got, want, soft_want):
    """Binary masks agree wherever the JAX probability is not at 0.5."""
    for g, w, s in zip(got, want, soft_want):
        assert g.shape == w.shape
        decided = np.abs(s - 0.5) > 1e-4
        np.testing.assert_array_equal(g[decided], w[decided])


def test_predict_paths_and_arrays_match_jax(predictors, tmp_path):
    port, ref = predictors
    path = tmp_path / "x.jpg"
    Image.fromarray(_images(0, 1, (80, 100))[0]).save(path)
    inputs = [str(path), _images(1, 1)[0]]
    masks = port.predict(inputs)
    assert len(masks) == 2
    for m in masks:
        assert m.shape == (56, 56) and set(np.unique(m)) <= {0.0, 1.0}
    _assert_masks_match(masks, ref.predict(inputs), ref.predict(inputs, soft=True))


@pytest.mark.parametrize("output_size", [None, (64, 72)])
@pytest.mark.parametrize("soft", [False, True])
def test_predict_soft_and_output_size_match_jax(predictors, soft, output_size):
    port, ref = predictors
    images = _images(3, 3)
    got = port.predict(images, soft=soft, output_size=output_size)
    want = ref.predict(images, soft=soft, output_size=output_size)
    shape = output_size or (56, 56)
    assert all(g.shape == shape for g in got)
    if soft:
        assert len(np.unique(got[0])) > 2 and all(0.0 <= g.min() and g.max() <= 1.0 for g in got)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    else:
        _assert_masks_match(got, want, ref.predict(images, soft=True, output_size=output_size))
        np.testing.assert_array_equal(
            got[0], (port.predict(images[:1], soft=True, output_size=output_size)[0] > 0.5).astype(np.float32)
        )


def test_predict_batching_consistency(predictors):
    """Results do not depend on how inputs are bucketed (5 = 4 + 1)."""
    port, _ = predictors
    images = _images(1, 5, (50, 60))
    singly = [port.predict([im])[0] for im in images]
    for a, b in zip(singly, port.predict(images)):
        np.testing.assert_array_equal(a, b)


def test_predict_look_twice_matches_jax(predictors, tmp_path):
    port, ref = predictors
    path = tmp_path / "lt.jpg"
    Image.fromarray(_images(4, 1, (90, 110))[0]).save(path)
    port.look_twice_th = ref.look_twice_th = 0.95  # force the zoom-in path
    try:
        got = port.predict([str(path)], look_twice=True)
        want = ref.predict([str(path)], look_twice=True)
    finally:
        port.look_twice_th = ref.look_twice_th = 0.15
    assert got[0].shape == (56, 56)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    with pytest.raises(ValueError):
        port.predict([np.zeros((56, 56, 3), np.float32)], look_twice=True)
    with pytest.raises(ValueError):
        port.predict([str(path)], look_twice=True, soft=True)


def test_predict_input_handling(predictors, tmp_path):
    """A bare path or single image is ONE input; malformed arrays raise."""
    port, _ = predictors
    path = tmp_path / "one.jpg"
    Image.fromarray(_images(3, 1, (60, 70))[0]).save(path)
    assert len(port.predict(str(path))) == 1
    assert len(port.predict(_images(5, 1)[0])) == 1
    assert len(port.predict(np.stack(_images(6, 3)))) == 3
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        port.predict(rng.random((60, 70)).astype(np.float32))
    with pytest.raises(ValueError, match="expected a path"):
        port.predict([rng.random((60, 70, 3)).astype(np.float32)])


def test_predict_loads_lazily_per_chunk(predictors, monkeypatch):
    """Inputs are decoded per device batch, not all up front."""
    port, _ = predictors
    live = []
    orig_load, orig_bucket = Predictor._load, Predictor._bucket

    def tracked_load(self, item):
        live.append(1)
        return orig_load(self, item)

    seen = []

    def tracked_bucket(self, n):
        seen.append(len(live))
        live.clear()
        return orig_bucket(self, n)

    monkeypatch.setattr(Predictor, "_load", tracked_load)
    monkeypatch.setattr(Predictor, "_bucket", tracked_bucket)
    assert len(port.predict(_images(7, 10, (40, 50)))) == 10
    assert seen == [4, 4, 2]


def test_strict_weight_loading(tmp_path):
    cfg = _fe_cfg(backbone_weights=str(tmp_path / "nonexistent"))
    with pytest.raises(FileNotFoundError):
        FeatureExtractor(cfg, device="cpu", strict=True)
    cfg.strict_weights = True
    with pytest.raises(FileNotFoundError):
        FeatureExtractor(cfg, device="cpu")
    cfg.strict_weights = False
    fe = FeatureExtractor(cfg, device="cpu", seed=3)
    feats = fe.extract(np.zeros((1, 56, 56, 3), np.float32))
    assert feats.shape == (1, 4, 4, DIM) and feats.dtype == np.float32


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without ``device`` the extractor and ``Predictor.from_config`` run on
    CUDA; on a machine without a card that raises at construction, naming
    CUDA, instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FeatureExtractor(_fe_cfg())
    config = tmp_path / "cfg.py"
    config.write_text(
        "cfg = dict(dataset_cfg=dict(feature_extractor_cfg=dict(type='dinov2', backbone='facebook/dinov2-base',\n"
        "    backbone_weights='none', arch=dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,\n"
        "    image_size=56)), valset_cfg=dict(image_size=(56, 56))), model_cfg=dict(feature_size=8), val_cfg=dict())\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor.from_config(str(config), str(tmp_path / "unused.safetensors"), strict=False)
