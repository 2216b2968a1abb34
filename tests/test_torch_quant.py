"""The port's int8 (W8A8) serving path against the JAX package.

The same numpy inputs and weights go through ``ucod_dpl_tpu.ops.quant`` /
``ucod_dpl_tpu.ops.fused_layers`` (their Pallas kernels in interpret mode,
UCOD_PALLAS_INTERPRET=1) and through the port's plain versions of K8-K11, at
the tolerances of tests/test_quant.py.

Under ``jax.jit`` XLA turns the ``/ 127.0`` of the scales into a multiply by
the reciprocal: 3% of the scales below then differ from a true division by
one f32 ulp (eager JAX divides).  The port multiplies by ``1 / 127`` on every
device, as the jitted JAX package does, so it matches jitted JAX exactly and
eager JAX within rtol 1e-6, with codes one step apart at rounding ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.models import dba as JB
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.ops import fused_layers as JF
from ucod_dpl_tpu.ops import quant as JQ
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dba as TB
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.ops import fused_layers as TF
from ucod_dpl_tpu_torch.ops import quant as TQ

from test_torch_dinov1 import on_dinov1

# the two shipped families at full width, 2 layers, 56px: dinov2-base (patch
# 14, layerscale, eps 1e-6) and ViT-B/8 (patch 8, no layerscale, eps 1e-12)
VARIANTS = ("dinov2", "dinov1")
TINY = {v: dataclasses.replace(JD.DinoConfig.from_type(v), image_size=56, num_layers=2) for v in VARIANTS}
TINY_T = {v: TD.DinoConfig(**dataclasses.asdict(c)) for v, c in TINY.items()}


def _assert_codes_close(got, want):
    """Codes equal, or one step apart (a rounding tie) at <= 1% of them."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() <= 0.01, (diff != 0).mean()


def _linear_np(rng, d_in, d_out, w_scale=None):
    """A float32 linear in the JAX (in, out) layout."""
    w = rng.standard_normal((d_in, d_out)).astype(np.float32) / np.float32(w_scale or d_in ** 0.5)
    return {"w": w, "b": (0.1 * rng.standard_normal(d_out)).astype(np.float32)}


def _q8_pair(lin):
    """One float32 linear quantized by JAX (numpy tree) and by the port."""
    jq = jax.tree_util.tree_map(np.asarray, JQ.quantize_linear({k: jnp.asarray(v) for k, v in lin.items()}))
    tq = TQ.quantize_linear({"w": torch.from_numpy(lin["w"].T.copy()), "b": torch.from_numpy(lin["b"])})
    return jq, tq


def _norm_np(rng, d):
    return {"scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jit", [False, True])
def test_quantize_linear_and_act_match_jax(jit):
    rng = np.random.default_rng(0)
    lin = _linear_np(rng, 256, 192, w_scale=20.0)
    # rows over six decades, an all-zero row (scale 1e-12, codes 0) and a constant row
    x = rng.standard_normal((40, 256)).astype(np.float32) * np.logspace(-3, 3, 40, dtype=np.float32)[:, None]
    x[3] = 0.0
    x[4] = 0.75
    qlin = jax.jit(JQ.quantize_linear) if jit else JQ.quantize_linear
    qact = jax.jit(JQ.quantize_act) if jit else JQ.quantize_act
    jq = qlin(_j(lin))
    tq = TQ.quantize_linear({"w": torch.from_numpy(lin["w"].T.copy()), "b": torch.from_numpy(lin["b"])})
    assert tq["w_q"].dtype == torch.int8 and tq["w_q"].shape == (192, 256)
    _assert_codes_close(tq["w_q"].numpy().T, jq["w_q"])
    np.testing.assert_allclose(tq["w_s"].numpy(), np.asarray(jq["w_s"]), rtol=1e-6)
    np.testing.assert_array_equal(tq["b"].numpy(), lin["b"])

    jx_q, jx_s = qact(jnp.asarray(x))
    tx_q, tx_s = TQ.quantize_act(torch.from_numpy(x))
    if jit:  # the same multiply by 1 / 127: bit for bit
        np.testing.assert_array_equal(tx_s.numpy(), np.asarray(jx_s))
        np.testing.assert_array_equal(tq["w_s"].numpy(), np.asarray(jq["w_s"]))
    assert tx_s.shape == (40, 1) and tx_q.dtype == torch.int8
    _assert_codes_close(tx_q.numpy(), jx_q)
    np.testing.assert_allclose(tx_s.numpy(), np.asarray(jx_s), rtol=1e-6)
    assert tx_s[3].item() == pytest.approx(1e-12) and not tx_q[3].any()
    assert set(np.unique(tx_q[4].numpy())) == {127}
    # the exact int32 product and the f32 rescale of dense_w8a8
    want = JQ.dense_w8a8(jnp.asarray(x), jq, jnp.float32)
    got = TQ.dense_w8a8(torch.from_numpy(x), tq, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_quantize_dino_linears_matches_jax_and_round_trips(variant="dinov2"):
    params = JD.init_dino(jax.random.PRNGKey(0), TINY[variant])
    jq = jax.tree_util.tree_map(np.asarray, jax.jit(JQ.quantize_dino_linears)(params))
    want = C.quant_from_jax(jq)
    got = TQ.quantize_dino_linears(C.dino_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert len(got["layers"]) == 2 and set(got["layers"][0]) == {"q", "k", "v", "out", "fc1", "fc2"}
    for lg, lw in zip(got["layers"], want["layers"]):
        for name in lg:
            assert lg[name]["w_q"].shape == lw[name]["w_q"].shape
            _assert_codes_close(lg[name]["w_q"].numpy(), lw[name]["w_q"].numpy())
            np.testing.assert_allclose(lg[name]["w_s"].numpy(), lw[name]["w_s"].numpy(), rtol=1e-6)
            np.testing.assert_array_equal(lg[name]["b"].numpy(), lw[name]["b"].numpy())
    assert got["layers"][0]["fc1"]["w_q"].shape == (3072, 768)  # (out, in)
    back = C.quant_to_jax(want)
    for a, b in zip(jax.tree_util.tree_leaves(jq), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


test_quantize_dino_linears_matches_jax_and_round_trips_on_dinov1 = on_dinov1(
    test_quantize_dino_linears_matches_jax_and_round_trips)


def test_int_matmul_is_exact():
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, (3, 5, 3072), dtype=np.int8)
    w = rng.integers(-127, 128, (24, 3072), dtype=np.int8)
    got = TQ.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (3, 5, 24)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


# ---------------------------------------------------------------------------
# plain versions of K8-K11 against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 768])
def test_layernorm_qkv_w8a8_plain_matches_jax_kernel(monkeypatch, d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    norm = _norm_np(rng, d)
    pairs = [_q8_pair(_linear_np(rng, d, d)) for _ in range(3)]
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = JF.layernorm_qkv_w8a8(jnp.asarray(x), _j(norm), *(_j(jq) for jq, _ in pairs), eps=1e-6)
    before = TF.layernorm_qkv_w8a8.launches
    got = TF.layernorm_qkv_w8a8(torch.from_numpy(x), _t(norm), *(tq for _, tq in pairs), 1e-6)
    assert TF.layernorm_qkv_w8a8.launches == before  # CPU tensors take the plain version
    h_s = TQ.quantize_act(TF._layernorm_f32(torch.from_numpy(x), _t(norm), 1e-6))[1].max().item()
    quantum = h_s * max(float(np.max(jq["w_s"])) for jq, _ in pairs)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() <= quantum + 1e-5, (diff.max(), quantum)
        assert (diff <= 1e-5).mean() > 0.99


@pytest.mark.parametrize("d,df", [(128, 256), (768, 3072)])
def test_layernorm_fc1_gelu_w8a8_plain_matches_jax_kernel(monkeypatch, d, df):
    """K9's plain version against the JAX kernel in interpret mode, also at
    the serving widths (768 -> 3072); 2 x 37 rows, not a multiple of 64."""
    rng = np.random.default_rng(5 + d)
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    norm = _norm_np(rng, d)
    jq, tq = _q8_pair(_linear_np(rng, d, df))
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want_q, want_s = JF.layernorm_fc1_gelu_w8a8(jnp.asarray(x), _j(norm), _j(jq), eps=1e-6)
    out = (torch.empty(2, 37, df, dtype=torch.int8), torch.empty(2, 37, 1))
    got_q, got_s = TF.layernorm_fc1_gelu_w8a8(torch.from_numpy(x), _t(norm), tq, 1e-6, out=out)
    assert got_q is out[0] and got_s is out[1]
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    diff = np.abs(got_q.numpy().astype(np.int32) - np.asarray(want_q, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.99


@pytest.mark.parametrize("f,width", [(1024, 64), (1536, 96), (2048, 128), (3072, 192)])
def test_k9_width_splits_the_expansion_over_the_cluster(f, width):
    """K9's wrapper gives each of its 16 consumer warpgroups (8 CTAs x 2) F / 16
    columns, a wgmma width its main kernel is built for."""
    assert TF.k9_width(f) == width == f // TF.K9_COLUMN_PARTS
    assert width in TF.K9_WIDTHS


@pytest.mark.parametrize("f", [256, 512, 1280, 3000, 4096, 6144])
def test_k9_width_rejects_what_the_kernel_is_not_built_for(f):
    with pytest.raises(ValueError, match="expansion"):
        TF.k9_width(f)


def test_dense_quant_w8a8_plain_matches_jax_kernel(monkeypatch):
    rng = np.random.default_rng(9)
    d = 128
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    jq, tq = _q8_pair(_linear_np(rng, d, d))
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = JF.dense_quant_w8a8(jnp.asarray(x), _j(jq), jnp.float32)
    got = TF.dense_quant_w8a8(torch.from_numpy(x), tq, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_layernorm_mlp_w8a8_plain_matches_jax_kernel(monkeypatch):
    rng = np.random.default_rng(13)
    d, df = 128, 256
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    norm = _norm_np(rng, d)
    jq1, tq1 = _q8_pair(_linear_np(rng, d, df))
    jq2, tq2 = _q8_pair(_linear_np(rng, df, d))
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = np.asarray(JF.layernorm_mlp_w8a8(jnp.asarray(x), _j(norm), _j(jq1), _j(jq2), eps=1e-6))
    got = TF.layernorm_mlp_w8a8(torch.from_numpy(x), _t(norm), tq1, tq2, 1e-6).numpy()
    g_s = TF.layernorm_fc1_gelu_w8a8_reference(torch.from_numpy(x), _t(norm), tq1, 1e-6)[1]
    quantum = g_s.max().item() * float(np.max(jq2["w_s"])) * df
    diff = np.abs(got - want)
    assert diff.max() <= quantum + 1e-5, (diff.max(), quantum)
    assert (diff <= 1e-4).mean() > 0.99
    # the whole half is the split composition, exactly, in the port
    split = TQ.dense_w8a8_pre(*TF.layernorm_fc1_gelu_w8a8_reference(torch.from_numpy(x), _t(norm), tq1, 1e-6),
                              tq2, torch.float32)
    np.testing.assert_array_equal(got, split.numpy())


def test_layernorm_mlp_w8a8_plain_matches_jax_kernel_at_serving_widths(monkeypatch):
    """K11's plain version against the JAX kernel in interpret mode at the
    serving widths (768 -> 3072 -> 768), 2 x 37 rows (not a multiple of
    K11's 64-row tile), within the JAX test's bounds: one code step of the
    requantized expansion, and 99% of the outputs within 1e-4."""
    rng = np.random.default_rng(17)
    d, df = 768, 3072
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    norm = _norm_np(rng, d)
    jq1, tq1 = _q8_pair(_linear_np(rng, d, df))
    jq2, tq2 = _q8_pair(_linear_np(rng, df, d))
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = np.asarray(JF.layernorm_mlp_w8a8(jnp.asarray(x), _j(norm), _j(jq1), _j(jq2), eps=1e-6))
    before = TF.layernorm_mlp_w8a8.launches
    got = TF.layernorm_mlp_w8a8(torch.from_numpy(x), _t(norm), tq1, tq2, 1e-6).numpy()
    assert TF.layernorm_mlp_w8a8.launches == before  # CPU tensors take the plain version
    g_s = TF.layernorm_fc1_gelu_w8a8_reference(torch.from_numpy(x), _t(norm), tq1, 1e-6)[1]
    quantum = g_s.max().item() * float(np.max(jq2["w_s"])) * df
    diff = np.abs(got - want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert diff.max() <= quantum + 1e-5, (diff.max(), quantum)
    assert (diff <= 1e-4).mean() > 0.99


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(request):
    """Full width (768 hidden, 12 heads of 64), 2 layers, 56px, of dinov2-base
    (or of the family an indirect parameter names); the last two items are
    its JAX and port configs."""
    variant = getattr(request, "param", "dinov2")
    cfg, tcfg = TINY[variant], TINY_T[variant]
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp, jd = JD.init_dino(k1, cfg), JB.init_rev_decoder(k2, cfg.hidden_size)
    jq = jax.jit(JQ.quantize_dino_linears)(jp)
    tp = C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    td = C.decoder_from_jax(jax.tree_util.tree_map(np.asarray, jd))
    tq = TQ.quantize_dino_linears(tp)
    return jp, jd, jq, tp, td, tq, cfg, tcfg


def _agree(got, want, corr_min=0.999):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > corr_min, corr
    np.testing.assert_allclose(got, want, atol=0.05)


@pytest.mark.parametrize("int8_mlp", ["split", "whole"])
def test_dino_forward_int8_matches_jax(tiny, monkeypatch, int8_mlp):
    jp, _, jq, tp, _, tq, cfg, tcfg = tiny
    px = np.random.default_rng(3).standard_normal((1, 56, 56, 3)).astype(np.float32)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    if int8_mlp == "whole":
        monkeypatch.setenv("UCOD_INT8_WHOLE_MLP", "1")
    want = JD.dino_forward(jp, jnp.asarray(px), cfg, quant=jq)["key_features"]
    got = TD.dino_forward(tp, torch.from_numpy(px), tcfg, quant=tq, int8_mlp=int8_mlp)["key_features"]
    _agree(got.numpy(), want)
    full = TD.dino_forward(tp, torch.from_numpy(px), tcfg)["key_features"]
    assert not torch.equal(got, full)  # the int8 path was taken


test_dino_forward_int8_matches_jax_on_dinov1 = on_dinov1(test_dino_forward_int8_matches_jax, "tiny")


def test_fg_logits_live_int8_matches_jax(tiny, monkeypatch):
    jp, jd, jq, tp, td, tq, cfg, tcfg = tiny
    px = np.random.default_rng(4).standard_normal((2, 56, 56, 3)).astype(np.float32)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want, _, _ = JB.fg_logits_live(jp, jd, jnp.asarray(px), cfg, compute_dtype=jnp.float32, size=8, quant=jq)
    got, _, _ = TB.fg_logits_live(tp, td, torch.from_numpy(px), tcfg, compute_dtype=torch.float32, size=8,
                                  quant=tq)
    _agree(got.numpy(), want)
    ref, _, _ = TB.fg_logits_live(tp, td, torch.from_numpy(px), tcfg, compute_dtype=torch.float32, size=8)
    assert np.mean((ref.numpy() > 0) == (got.numpy() > 0)) > 0.9


test_fg_logits_live_int8_matches_jax_on_dinov1 = on_dinov1(test_fg_logits_live_int8_matches_jax, "tiny")


def _fe_cfg(variant="dinov2"):
    from ucod_dpl_tpu.config import CfgNode

    return CfgNode({"type": variant,
                    "backbone": "facebook/dinov2-base" if variant == "dinov2" else "facebook/dino-vitb8",
                    "backbone_weights": "none", "arch": {"num_layers": 2, "image_size": 56}})


def test_predictor_int8_agrees_with_full_precision(variant="dinov2"):
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.serving import Predictor

    fe32 = FeatureExtractor(_fe_cfg(variant), device="cpu", seed=2)
    fe8 = FeatureExtractor(_fe_cfg(variant), device="cpu", seed=2, quantize="int8")
    assert fe8.config == TINY_T[variant]
    decoder = TB.init_rev_decoder(3, 768)
    kw = dict(image_size=(56, 56), feature_size=8, max_batch=4)
    p32 = Predictor(fe32, decoder, **kw)
    p8 = Predictor(fe8, decoder, **kw)  # an int8 extractor opts the Predictor in
    assert p32.quantize is None and p8.quantize == "int8" and p8._qparams is fe8._qparams
    p8_own = Predictor(fe32, decoder, quantize="int8", **kw)  # quantized from fe32's f32 weights
    rng = np.random.default_rng(5)
    imgs = [(rng.random((60, 70, 3)) * 255).astype(np.uint8) for _ in range(3)]
    m32, m8, m8_own = p32.predict(imgs), p8.predict(imgs), p8_own.predict(imgs)
    for a, b, c in zip(m32, m8, m8_own):
        assert b.shape == (56, 56) and set(np.unique(b)) <= {0.0, 1.0}
        assert np.mean(a == b) > 0.9, np.mean(a == b)
        np.testing.assert_array_equal(b, c)

    px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref, got = fe32.extract(px), fe8.extract(px)
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.99
    assert not np.array_equal(ref, got)


test_predictor_int8_agrees_with_full_precision_on_dinov1 = on_dinov1(test_predictor_int8_agrees_with_full_precision)


def test_extractor_quantizes_float32_weights_before_the_cast():
    """A bf16 extractor's int8 linears come from its float32 weights, as JAX
    quantizes its float32 params, not from the bf16 copy it holds."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor

    fe = FeatureExtractor(_fe_cfg(), device="cpu", seed=4, compute_dtype=torch.bfloat16, quantize="int8")
    masters = TD.init_dino(4, fe.config)
    want = C.quant_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(JQ.quantize_dino_linears)(_j(C.dino_to_jax(masters)))))
    from_bf16 = TQ.quantize_dino_linears(TD.cast_params(masters, torch.bfloat16))
    assert fe.params["layers"][0]["fc1"]["w"].dtype == torch.bfloat16
    changed = 0
    for lg, lw, lb in zip(fe._qparams["layers"], want["layers"], from_bf16["layers"][:-1]):
        for name in lb:
            _assert_codes_close(lg[name]["w_q"].numpy(), lw[name]["w_q"].numpy())
            np.testing.assert_allclose(lg[name]["w_s"].numpy(), lw[name]["w_s"].numpy(), rtol=1e-6)
            changed += int(not torch.equal(lg[name]["w_q"], lb[name]["w_q"]))
    assert changed > 0  # the bf16 copy would have given other codes
    # a bf16 extractor built without quantize loads its float32 weights again
    plain = FeatureExtractor(_fe_cfg(), device="cpu", seed=4, compute_dtype=torch.bfloat16)
    again = plain.int8_params()
    for a, b in zip(C.quant_to_jax(again)["layers"], C.quant_to_jax(fe._qparams)["layers"]):
        for name in a:
            np.testing.assert_array_equal(a[name]["w_q"], b[name]["w_q"])


def test_int8_guards(tiny):
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.serving import Predictor

    _, _, _, tp, td, tq, _, tcfg = tiny
    px = torch.zeros(1, 56, 56, 3)
    with pytest.raises(ValueError, match="inference-only"):
        TD.dino_forward(tp, px, tcfg, quant=tq, differentiable=True)
    with pytest.raises(ValueError, match="int8_mlp"):
        TD.dino_forward(tp, px, tcfg, quant=tq, int8_mlp="fused")
    with pytest.raises(ValueError, match="int8"):
        FeatureExtractor(_fe_cfg(), device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="qkv_masters"):
        FeatureExtractor(_fe_cfg(), device="cpu", quantize="int8", qkv_masters=True)
    fe = FeatureExtractor(_fe_cfg(), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        Predictor(fe, td, quantize="int4")


test_int8_guards_on_dinov1 = on_dinov1(test_int8_guards, "tiny")
