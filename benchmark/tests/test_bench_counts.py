"""Each metric's count of operations and bytes against a sum by hand at the
cells' shapes (dinov2-base and ViT-B/8: D 768, 12 heads of 64, MLP 3072)."""

import pytest

from benchmark.harness import manifest
from benchmark.harness.peaks import PEAK_BF16, PEAK_HBM

V2, V1 = manifest.config("ucod_dpl_dinov2"), manifest.config("ucod_dpl_dinov1")
D, F = 768, 3072


def block(l):
    """One ViT block: q, k, v, out (4 products of (l, D) x (D, D)), QK^T and
    PV over 12 heads of 64, fc1 and fc2."""
    return 4 * (2 * l * D * D) + 2 * (2 * 12 * l * l * 64) + 2 * (2 * l * D * F)


@pytest.mark.parametrize("cell,cfg,size,patch", [
    ("dinov2-predict-518-bs16", V2, 518, 14), ("dinov1-predict-296-bs16", V1, 296, 8)])
def test_mfu_infer_predict(cell, cfg, size, patch):
    g = size // patch  # 37: 1369 patches, 1370 tokens
    n, l = g * g, g * g + 1
    embed = 2 * n * (3 * patch * patch) * D
    fold = 2 * n * D * 128
    decoder = 128 * (2 * 68 * g * g + 2 * 68 * g * 68) + (2 * size * 68 * 68 + 2 * size * 68 * size)
    want = embed + 11 * block(l) + fold + decoder
    got = manifest.metric("mfu.infer").ops_per_image(cfg, manifest.workload(cell))
    assert got == want
    assert 2.7e11 < got < 2.9e11


def test_mfu_infer_extract():
    n, l = 54 * 54, 54 * 54 + 1
    want = 2 * n * 588 * D + 11 * block(l) + 2 * n * D * D
    got = manifest.metric("mfu.infer").ops_per_image(V2, manifest.workload("dinov2-extract-756-bs8"))
    assert got == want


def test_roofline_bounds_at_bs16_l1370():
    """The bounds of PERF.md's kernel table: K1 0.0933 ms, K6 0.0784 ms,
    both by operations."""
    fwd = manifest.metric("attn_fwd_roofline").bound(16, 1370, 768, 12, 2)
    assert fwd == pytest.approx(4 * 16 * 12 * 1370 ** 2 * 64 / PEAK_BF16)
    assert fwd * 1e3 == pytest.approx(0.0933, abs=5e-5)
    ln = manifest.metric("lnqkv_roofline").bound(16 * 1370, 768, 2)
    assert ln == pytest.approx(2 * 16 * 1370 * 768 * 2304 / PEAK_BF16)
    assert ln * 1e3 == pytest.approx(0.0784, abs=5e-5)


def test_bytes_bound_a_small_call():
    """At one token the bytes bound the calls: q, k, v, o in bf16 for the
    forward; x, the three weights and q, k, v (and the f32 vectors) for K6."""
    assert manifest.metric("attn_fwd_roofline").bound(1, 1, 768, 12, 2) == pytest.approx(4 * 768 * 2 / PEAK_HBM)
    want = ((4 * 768 + 3 * 768 * 768) * 2 + 5 * 768 * 4) / PEAK_HBM
    assert manifest.metric("lnqkv_roofline").bound(1, 768, 2) == pytest.approx(want)
