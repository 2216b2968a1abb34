"""The plain reference against the port at a small seeded case on the CPU,
both in float32: the ViT (DINOv2 at its own grid and interpolated; DINOv1),
and the prediction (fold, decoder, upsample, sigmoid)."""

import numpy as np
import pytest
import torch

from benchmark.harness import program, weights
from benchmark.reference import decoder as ref_decoder, vit as ref_vit
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _close(got, want, tol):
    err = float((got - want).norm() / want.norm())
    assert err < tol, err


@pytest.mark.parametrize("cell,size", [("dinov2-predict-518-bs16", 28), ("dinov2-predict-518-bs16", 42),
                                       ("dinov1-predict-296-bs16", 24)])
def test_vit_key_features(cell, size):
    from ucod_dpl_tpu_torch.models.dino import dino_forward

    cfg = tiny.config_for(cell)
    w = weights.make(weights.dino_plan(cfg), 3, "weights", CPU)
    px = weights.images(3, 2, size, CPU)
    fe = program.extractor(cfg, weights.make(weights.dino_plan(cfg), 3, "weights", CPU), CPU, torch.float32)
    got = dino_forward(fe.params, px, fe.config, compute_dtype=torch.float32)["key_features"]
    _close(got, ref_vit.key_features(w, px, cfg), 1e-5)


def test_prediction():
    from ucod_dpl_tpu_torch import serving
    from ucod_dpl_tpu_torch.models.dba import RevDecoderParams

    cfg = tiny.config_for("dinov2-predict-518-bs16")
    dec = weights.make(weights.decoder_plan(cfg), 5, "decoder", CPU)
    fe = program.extractor(cfg, weights.make(weights.dino_plan(cfg), 5, "weights", CPU), CPU, torch.float32)
    pred = serving.Predictor(fe, RevDecoderParams(**dec), image_size=(42, 42), feature_size=8, max_batch=4)
    px = weights.images(5, 3, 42, CPU)
    got = torch.from_numpy(np.stack(pred.predict(px.numpy(), soft=True)))
    w = weights.make(weights.dino_plan(cfg), 5, "weights", CPU)
    want = ref_decoder.probabilities(dec, ref_vit.key_features(w, px, cfg), 8, 42)
    _close(got - 0.5, want - 0.5, 1e-5)
