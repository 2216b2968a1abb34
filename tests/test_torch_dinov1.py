"""The DINOv1 family (ViT-B/8: patch 8, LayerNorm eps 1e-12, no layerscale)
through the port against the JAX package.

The same numpy inputs and weights (the JAX ``init_dino`` tree carried across
by ``ucod_dpl_tpu_torch.models.convert``) go through both packages; the JAX
side runs its Pallas kernels in interpret mode.  A small ViT-B/8 (hidden 128,
two heads of 64, three layers, the 28 x 28 position grid of 224px) keeps the
JAX attention and its fused LayerNorm on their kernels.  Tolerances: the
position embeddings, the f32 forward and the fused LayerNorm + q/k/v 1e-5
(tests/test_dino_parity.py:179); attention 1e-5 in f32 and its gradients
rtol 2e-4 / atol 2e-5 (tests/test_attention_vjp.py:64); the bf16 live
forward no further from the f32 JAX path than 1.5 x the JAX bf16 path's
error + 1e-3 (the rule the card holds the kernels to); the int8 paths
within one code step, as tests/test_torch_quant.py; LookTwice's crops,
boxes and pasted masks exactly.
"""

import dataclasses
import functools
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucod_dpl_tpu.engine import eval_loop as JE
from ucod_dpl_tpu.models import dba as JB
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.ops import attention as JA
from ucod_dpl_tpu.ops import fused_layers as JF
from ucod_dpl_tpu.ops import quant as JQ
from ucod_dpl_tpu_torch.engine import eval_loop as TE
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dba as TB
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.ops import attention as TA
from ucod_dpl_tpu_torch.ops import fused_layers as TF
from ucod_dpl_tpu_torch.ops import quant as TQ

ARCH = dict(hidden_size=128, num_layers=3, num_heads=2)
SMALL = dataclasses.replace(JD.DinoConfig.dinov1_vitb8(), **ARCH)
SMALL_T = TD.DinoConfig(**dataclasses.asdict(SMALL))
EPS = 1e-12
TOL = dict(rtol=1e-5, atol=1e-5)


def on_dinov1(test, fixture=None):
    """A twin of the port test ``test`` on DINOv1 (ViT-B/8), for the other
    port test files: ``test`` keeps its dinov2-base case and its id.  With
    ``fixture``, that module fixture is built for DINOv1 (an indirect
    parameter, which the fixture reads as ``request.param``, dinov2 by
    default); without, ``test``'s ``variant`` argument (default "dinov2")
    is "dinov1".  Bind the twin to a ``test_*`` name for pytest to collect
    it."""
    sig = inspect.signature(test)

    @functools.wraps(test)
    def twin(*args, **kwargs):
        return test(*args, **kwargs) if fixture else test(*args, variant="dinov1", **kwargs)

    if fixture:
        return pytest.mark.parametrize(fixture, ["dinov1"], indirect=True)(twin)
    twin.__signature__ = sig.replace(parameters=[p for n, p in sig.parameters.items() if n != "variant"])
    return twin


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def small():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp, jd = JD.init_dino(k1, SMALL), JB.init_rev_decoder(k2, SMALL.hidden_size)
    jq = jax.jit(JQ.quantize_dino_linears)(jp)
    tp = C.dino_from_jax(_np(jp))
    return jp, jd, jq, tp, C.decoder_from_jax(_np(jd)), TQ.quantize_dino_linears(tp)


def _pixels(seed, b, hw):
    return np.random.default_rng(seed).standard_normal((b, *hw, 3)).astype(np.float32)


# -- models/dino.py ------------------------------------------------------------------

def test_dinov1_config_matches_jax():
    want = JD.DinoConfig.dinov1_vitb8()
    got = TD.DinoConfig.dinov1_vitb8()
    assert dataclasses.asdict(got) == dataclasses.asdict(want) == dataclasses.asdict(JD.DinoConfig.from_type("dinov1"))
    assert TD.DinoConfig.from_type("dinov1") == got
    assert (got.patch_size, got.layer_norm_eps, got.use_layerscale, got.head_dim) == (8, 1e-12, False, 64)
    assert (got.image_size // got.patch_size) ** 2 + 1 == 785


@pytest.mark.parametrize("grid", [37, 54, 28, (37, 28)])
def test_interpolate_pos_embed_matches_jax(grid):
    """ViT-B/8's 28 x 28 position grid (224px) at width 768 to the 296px
    grid (37), the 432px m-patch grid (54), itself (passed through) and a
    non-square grid."""
    hw = (grid, grid) if isinstance(grid, int) else grid
    pos = (0.02 * np.random.default_rng(sum(hw)).standard_normal((1, 785, 768))).astype(np.float32)
    want = np.asarray(JD.interpolate_pos_embed(jnp.asarray(pos), hw, 28))
    got = TD.interpolate_pos_embed(torch.from_numpy(pos), hw, 28)
    assert tuple(got.shape) == want.shape == (1, 1 + hw[0] * hw[1], 768) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[:, 0].numpy(), pos[:, 0])
    if hw == (28, 28):
        np.testing.assert_array_equal(got.numpy(), pos)


def test_weights_carry_across_without_layerscale(small, tmp_path):
    """``dino_from_jax`` / ``dino_to_jax`` on a tree with no layerscale keys,
    and the ViTModel key names of a HuggingFace checkpoint written by either
    package, read by both, exactly."""
    jp, _, _, tp, _, _ = small
    assert set(tp["layers"][0]) == {"norm1", "q", "k", "v", "out", "norm2", "fc1", "fc2"}
    assert tuple(tp["patch_embed"]["kernel"].shape) == (128, 3, 8, 8)
    for a, b in zip(jax.tree_util.tree_leaves(_np(jp)), jax.tree_util.tree_leaves(C.dino_to_jax(tp))):
        np.testing.assert_array_equal(a, b)
    sd = TD.export_hf_state_dict(tp, SMALL_T)
    assert "encoder.layer.0.layernorm_before.weight" in sd and "encoder.layer.2.output.dense.bias" in sd
    assert not any("layer_scale" in k or ".mlp." in k for k in sd)
    assert set(sd) == set(JD.export_hf_state_dict(_np(jp), SMALL))
    TD.save_hf_checkpoint(str(tmp_path / "port.safetensors"), tp, SMALL_T)
    JD.save_hf_checkpoint(str(tmp_path / "jax.safetensors"), _np(jp), SMALL)
    for path in ("port.safetensors", "jax.safetensors"):
        for a, b in zip(jax.tree_util.tree_leaves(_np(JD.load_hf_checkpoint(str(tmp_path / path), SMALL))),
                        jax.tree_util.tree_leaves(_np(jp))):
            np.testing.assert_array_equal(a, b)
        got = C.dino_to_jax(TD.load_hf_checkpoint(str(tmp_path / path), SMALL_T))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np(jp))):
            np.testing.assert_array_equal(a, b)


def test_patch8_embed_matches_jax(small):
    """The patch-8 embed with the CLS token and the position grid 28 -> 9 x 7,
    against the JAX forward's embedding (its tokens before the first layer)."""
    jp, _, _, tp, _, _ = small
    px = _pixels(1, 2, (72, 56))
    zero = dataclasses.replace(SMALL, num_layers=1)
    jp0 = {**_np(jp), "layers": [_np(jp)["layers"][0]]}
    # one layer: the last layer's LN1 + key projection of the embedded tokens
    want = JD.dino_forward(jax.tree_util.tree_map(jnp.asarray, jp0), jnp.asarray(px), zero)["key_tokens"]
    x = TD._embed(tp, torch.from_numpy(px), SMALL_T, torch.float32)
    assert tuple(x.shape) == (2, 1 + 9 * 7, 128)
    k = TD.dense(TF.layer_norm(x, tp["layers"][0]["norm1"], EPS), tp["layers"][0]["k"], torch.float32)
    np.testing.assert_allclose(k.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(56, 56), (72, 56), (296, 296)])
def test_dino_forward_matches_jax(small, monkeypatch, hw):
    """The no-layerscale blocks in f32 (296px: L 1370, the shipped eval
    size), the JAX side through K1 and K6 in interpret mode."""
    jp, _, _, tp, _, _ = small
    px = _pixels(2, 1 if hw[0] > 100 else 2, hw)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = JD.dino_forward(jp, jnp.asarray(px), SMALL)
    got = TD.dino_forward(tp, torch.from_numpy(px), SMALL_T)
    assert tuple(got["key_features"].shape) == (px.shape[0], hw[0] // 8, hw[1] // 8, 128)
    for key in ("key_tokens", "key_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=1e-5)


def test_differentiable_forward_matches_plain(small):
    """``differentiable=True`` (LN + dense q/k/v, attention with log-sum-exp)
    gives the forward of the default routing on the no-layerscale blocks."""
    _, _, _, tp, _, _ = small
    px = torch.from_numpy(_pixels(3, 2, (64, 48)))
    want = TD.dino_forward(tp, px, SMALL_T)["key_features"]
    got = TD.dino_forward(tp, px, SMALL_T, differentiable=True)["key_features"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# -- models/dba.py::fg_logits_live ---------------------------------------------------------

@pytest.mark.parametrize("hw,size", [((64, 64), 8), ((296, 296), 68)])
def test_fg_logits_live_matches_jax_f32_and_bf16(small, monkeypatch, hw, size):
    """The key fold, then the decoder at ``size`` (68 at 296px, the shipped
    config): f32 within 2e-4 / 2e-5 of JAX; bf16 no further from JAX f32
    than 1.5 x JAX bf16 + 1e-3."""
    jp, jd, _, tp, td, _ = small
    px = _pixels(4, 2 if hw[0] < 100 else 1, hw)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    ref = np.asarray(JB.fg_logits_live(jp, jd, jnp.asarray(px), SMALL, compute_dtype=jnp.float32, size=size)[0])
    got = TB.fg_logits_live(tp, td, torch.from_numpy(px), SMALL_T, compute_dtype=torch.float32, size=size)[0]
    assert tuple(got.shape) == ref.shape == (px.shape[0], size, size, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)
    j16 = JB.fg_logits_live(jp, jd, jnp.asarray(px), SMALL, compute_dtype=jnp.bfloat16, size=size)[0]
    t16 = TB.fg_logits_live(TD.cast_params(tp, torch.bfloat16), td, torch.from_numpy(px), SMALL_T,
                            compute_dtype=torch.bfloat16, size=size)[0]
    err_j = np.abs(np.asarray(j16, np.float32) - ref).max()
    err_t = np.abs(t16.float().numpy() - ref).max()
    assert np.isfinite(err_t) and err_t <= 1.5 * err_j + 1e-3, (err_t, err_j)


@pytest.mark.parametrize("int8_mlp", ["split", "whole"])
def test_fg_logits_live_int8_matches_jax(small, monkeypatch, int8_mlp):
    """The int8 path (K8, K10, K9 and an int8 fc2, or K11) on the
    no-layerscale blocks at eps 1e-12, against JAX's kernels in interpret
    mode: correlated above 0.999, within 0.05, masks as the f32 path's."""
    jp, jd, jq, tp, td, tq = small
    px = _pixels(5, 2, (64, 64))
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    if int8_mlp == "whole":
        monkeypatch.setenv("UCOD_INT8_WHOLE_MLP", "1")
    want = np.asarray(JB.fg_logits_live(jp, jd, jnp.asarray(px), SMALL, compute_dtype=jnp.float32, size=8,
                                        quant=jq)[0])
    got = TB.fg_logits_live(tp, td, torch.from_numpy(px), SMALL_T, compute_dtype=torch.float32, size=8, quant=tq,
                            int8_mlp=int8_mlp)[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    np.testing.assert_allclose(got, want, atol=0.05)
    ref = TB.fg_logits_live(tp, td, torch.from_numpy(px), SMALL_T, compute_dtype=torch.float32, size=8)[0].numpy()
    assert not np.array_equal(got, ref) and np.mean((ref > 0) == (got > 0)) > 0.9


# -- ops/fused_layers.py at eps 1e-12 --------------------------------------------------------

def _rows_with_constant(seed, d):
    """(2, 37, d) rows of unit scale, one constant row (variance 0: only eps
    keeps rstd finite) and one of variance 1e-4, where DINOv2's eps 1e-6
    would move rstd by 0.5%, far past the tolerance."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    x[0, 3] = 0.75
    x[1, 5] = 0.5 + 1e-2 * rng.standard_normal(d).astype(np.float32)
    return x


def _norm(rng, d):
    return {"scale": (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}


def _linear(rng, d_in, d_out):
    return {"w": (rng.standard_normal((d_in, d_out)) / d_in ** 0.5).astype(np.float32),
            "b": (0.1 * rng.standard_normal(d_out)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def test_layernorm_qkv_at_eps_1e12_matches_jax_kernel(monkeypatch):
    """K6's plain version (what its wrapper runs on a CPU tensor) against
    the JAX kernel in interpret mode at DINOv1's eps, a constant row
    included."""
    d = 768
    rng = np.random.default_rng(6)
    x = _rows_with_constant(6, d)
    norm, lins = _norm(rng, d), [_linear(rng, d, d) for _ in range(3)]
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = JF.layernorm_qkv(jnp.asarray(x), *(jax.tree_util.tree_map(jnp.asarray, p) for p in (norm, *lins)),
                            eps=EPS)
    before = TF.layernorm_qkv.launches
    got = TF.layernorm_qkv(torch.from_numpy(x), _t(norm), *({"w": torch.from_numpy(p["w"].T.copy()),
                                                              "b": torch.from_numpy(p["b"])} for p in lins), EPS)
    assert TF.layernorm_qkv.launches == before  # a CPU tensor takes the plain version
    at_1e6 = TF.layernorm_qkv(torch.from_numpy(x), _t(norm), *({"w": torch.from_numpy(p["w"].T.copy()),
                                                                 "b": torch.from_numpy(p["b"])} for p in lins), 1e-6)
    rows = np.ones((2, 37), bool)
    rows[1, 5] = False
    for g, w, g6, lin in zip(got, want, at_1e6, lins):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[rows], w[rows], **TOL)
        # the constant row normalises to 0: its projection is LN's bias through the linear
        np.testing.assert_allclose(g[0, 3], norm["bias"] @ lin["w"] + lin["b"], **TOL)
        # the row of std 1e-2 amplifies the f32 rounding of its mean 100 times
        # (about 3e-5 here, in both packages' sums): held to 1e-4, while eps
        # 1e-6 in its place moves it by more than 1e-3
        assert np.abs(g[1, 5] - w[1, 5]).max() <= 1e-4
        assert np.abs(g6.numpy()[1, 5] - w[1, 5]).max() > 1e-3


def _q8(rng, d_in, d_out):
    lin = _linear(rng, d_in, d_out)
    jq = _np(JQ.quantize_linear(jax.tree_util.tree_map(jnp.asarray, lin)))
    tq = TQ.quantize_linear({"w": torch.from_numpy(lin["w"].T.copy()), "b": torch.from_numpy(lin["b"])})
    return jq, tq


def test_int8_layernorms_at_eps_1e12_match_jax_kernels(monkeypatch):
    """K8 (LN + quantize + q/k/v) and K9 (LN + quantize + fc1 + GELU +
    requantize) through their wrappers at eps 1e-12, a constant row
    included, against the JAX kernels in interpret mode: outputs within one
    code step, codes one apart at rounding ties, scales rtol 1e-5."""
    d, df = 768, 3072
    rng = np.random.default_rng(7)
    x = _rows_with_constant(7, d)
    norm = _norm(rng, d)
    qkv = [_q8(rng, d, d) for _ in range(3)]
    jq1, tq1 = _q8(rng, d, df)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    jn = jax.tree_util.tree_map(jnp.asarray, norm)
    want = JF.layernorm_qkv_w8a8(jnp.asarray(x), jn, *(jax.tree_util.tree_map(jnp.asarray, j) for j, _ in qkv),
                                 eps=EPS)
    got = TF.layernorm_qkv_w8a8(torch.from_numpy(x), _t(norm), *(t for _, t in qkv), EPS)
    h_s = TQ.quantize_act(TF._layernorm_f32(torch.from_numpy(x), _t(norm), EPS))[1].max().item()
    quantum = h_s * max(float(np.max(j["w_s"])) for j, _ in qkv)
    for g, w in zip(got, want):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert np.isfinite(g.numpy()).all() and diff.max() <= quantum + 1e-5, (diff.max(), quantum)
        assert (diff <= 1e-5).mean() > 0.99
    want_q, want_s = JF.layernorm_fc1_gelu_w8a8(jnp.asarray(x), jn, jax.tree_util.tree_map(jnp.asarray, jq1),
                                                eps=EPS)
    got_q, got_s = TF.layernorm_fc1_gelu_w8a8(torch.from_numpy(x), _t(norm), tq1, EPS)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    codes = np.abs(got_q.numpy().astype(np.int32) - np.asarray(want_q, np.int32))
    assert codes.max() <= 1 and (codes == 0).mean() > 0.99
    # K10 on the same rows (no LayerNorm: eps does not reach it)
    jq2, tq2 = _q8(rng, d, d)
    want = JF.dense_quant_w8a8(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, jq2), jnp.float32)
    got = TF.dense_quant_w8a8(torch.from_numpy(x), tq2, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- ops/attention.py at DINOv1's lengths -------------------------------------------------

def _qkv(seed, l):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, l, 128)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("l", [785, 1370, 2917])
def test_packed_attention_matches_jax_kernel(l):
    """K1's plain version against the JAX kernel in interpret mode at 224px
    (pseudo-labels), 296px (serving, eval) and 432px (m-patches)."""
    q, k, v = _qkv(l, l)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA._pallas_attention_packed(*(jnp.asarray(a) for a in (q, k, v)), 2, 0.125))
    got = TA.packed_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2, 0.125)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("backward", ["K3", "K4"])
def test_attention_grads_at_1370_match_jax(monkeypatch, backward):
    """K2 + the flash backward at L 1370 (the LoRA step at 296px): the JAX
    VJP takes K3 (whole KV) at this length; K4 (KV-blocked) is forced as
    tests/test_torch_attention_grad.py forces it."""
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    q, k, v = _qkv(11, 1370)
    if backward == "K4":
        monkeypatch.setattr(JA, "_bwd_block_q", lambda lp, itemsize: None)
    else:
        assert JA._bwd_block_q(JA._ceil_to(1370, 128), 4) is not None
    jax.clear_caches()
    try:
        want = jax.grad(lambda *a: jnp.sum(JA._packed_attention_diff(*a, 2, 0.125, False) ** 2), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    finally:
        jax.clear_caches()
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    torch.sum(TA.packed_attention_diff(*t, 2, 0.125) ** 2).backward()
    for name, a, w in zip("qkv", t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=f"d{name}")


# -- ops/pseudo_label.py on ViT-B/8's 28 x 28 grid (224px, L 785) --------------------------

@pytest.fixture(scope="module")
def cls_224(small):
    """Both packages' CLS attention and key tokens of two 224px images."""
    jp, _, _, tp, _, _ = small
    px = _pixels(12, 2, (224, 224))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UCOD_PALLAS_INTERPRET", "1")
        out_j = JD.dino_forward(jp, jnp.asarray(px), SMALL, want_cls_attention=True)
    return _np(out_j), TD.dino_forward(tp, torch.from_numpy(px), SMALL_T, want_cls_attention=True)


@pytest.mark.parametrize("th", [0.6, 0.3])
def test_pseudo_labels_on_the_28_grid_match_jax(cls_224, th):
    """The generator's inputs at its 224px (the last layer's CLS attention
    and key tokens, 1e-5) and its background masks on the 28 x 28 grid at
    its default threshold and at UCOD-DPL_dinov1.py's ``bkg_th`` 0.3:
    equal but where the JAX similarity lies within 1e-4 of the threshold
    (tests/test_torch_pseudo_label.py's rule)."""
    from test_torch_pseudo_label import _near_threshold

    from ucod_dpl_tpu.ops import pseudo_label as JPL
    from ucod_dpl_tpu_torch.ops import pseudo_label as TPL

    out_j, out_t = cls_224
    assert tuple(out_t["cls_attention"].shape) == (2, 2, 785)
    for key in ("cls_attention", "key_tokens"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]), **TOL)
    attn, toks = np.asarray(out_j["cls_attention"]), np.asarray(out_j["key_tokens"])
    bkg_j, _ = JPL.compute_background_mask(jnp.asarray(attn), jnp.asarray(toks), (28, 28), th)
    bkg_t, _ = TPL.compute_background_mask(torch.from_numpy(attn), torch.from_numpy(toks), (28, 28), th)
    assert tuple(bkg_t.shape) == np.asarray(bkg_j).shape == (2, 28, 28)
    near = _near_threshold(jnp.asarray(attn), jnp.asarray(toks), (28, 28), th, None, True)
    assert not ((bkg_t.numpy() != np.asarray(bkg_j)) & ~near).any()
    assert 0 < np.asarray(bkg_j).mean() < 1
    for m in 1.0 - bkg_t.numpy():
        np.testing.assert_array_equal(TPL.refine_small_components(m), JPL.refine_small_components(m))


# -- engine/eval_loop.py: LookTwice's fixed box at 296px ------------------------------------------

def test_look_twice_fixed_box_crosses_the_edge_as_in_jax():
    """A first pass with no foreground gives the reference's fixed box
    [129, 129, 259, 259], sized for 518px; at 296px it runs past the
    image's edge.  Both packages crop (PIL fills past the edge with black),
    normalise and paste the refined mask back (clipped at the edge)
    identically."""
    size = (296, 296)
    empty = np.zeros(size, np.float32)
    boxes = TE.find_refine_bboxes(empty, size, 0.05, "dynamic")
    assert boxes == JE.find_refine_bboxes(empty, size, 0.05, "dynamic") == [[129, 129, 259, 259]]
    assert boxes[0][0] + boxes[0][2] > size[1]
    img = Image.fromarray(np.random.default_rng(8).integers(0, 256, (260, 350, 3), dtype=np.uint8))
    tb, tcrops = TE.prepare_crops(img, boxes, size)
    jb, jcrops = JE.prepare_crops(img, boxes, size)
    assert tb == jb and len(tcrops) == len(jcrops) == 1
    np.testing.assert_array_equal(tcrops[0], jcrops[0])
    assert tcrops[0].shape == (296, 296, 3)
    # the part of the crop past the image's edge is black before normalisation
    black = TE.image_transform(Image.new("RGB", (4, 4)), None)[0, 0]
    np.testing.assert_array_equal(tcrops[0][-1, -1], black)
    pred = (np.random.default_rng(9).random((1, 37, 37)) > 0.5).astype(np.float32)
    got, want = TE.paste_refined(empty, tb, pred), JE.paste_refined(empty, jb, pred)
    assert got.shape == size
    np.testing.assert_array_equal(got, want)
    assert got[:129].max() == 0 and got[129:, 129:].max() > 0


# -- the entries on the shipped DINOv1 configs, narrowed to the small backbone -------------

REPO = Path(__file__).resolve().parent.parent
NARROW = {"hidden_size": 128, "num_layers": 2, "num_heads": 2}


def _entry_world(root, sets):
    """Two blob images a set (labels too) at COD-like sizes, a seeded
    HuggingFace checkpoint of the narrow ViT-B/8 and a decoder checkpoint."""
    from test_torch_coral import _write_images

    for name in sets:
        _write_images(root / "RefCOD", name, 2, len(name))
    dcfg = dataclasses.replace(TD.DinoConfig.dinov1_vitb8(), **NARROW)
    (root / "hf").mkdir()
    TD.save_hf_checkpoint(str(root / "hf" / "model.safetensors"), TD.init_dino(0, dcfg), dcfg)
    return dcfg


def _config_over(root, shipped, tag, **cfg):
    """A config file over ``configs/uscod/<shipped>``: the narrow backbone
    and decoder width, ``cfg`` merged on top; each package's run gets its
    own cache and log directories."""
    over = {"_BASE_": [str(REPO / "configs" / "uscod" / shipped)],
            "model_cfg": {"dim": 128, **cfg.pop("model_cfg", {})},
            "dataset_cfg": {"dataset_dir": str(root / "RefCOD"), "cache_dir": str(root / f"cache_{tag}"),
                            "feature_extractor_cfg": {"backbone_weights": str(root / "hf"), "arch": dict(NARROW)}},
            **cfg}
    path = root / f"{tag}.py"
    path.write_text(f"cfg = {over!r}\n")
    return ["-c", str(path), "--work_dir", str(root / f"wd_{tag}")]


def _log_opts(root, tag):
    return ["--opts", "log_cfg.log_path", str(root / f"logs_{tag}")]


def _preds(log_path, name):
    d = Path(log_path) / "preds" / name
    return {f.name: np.asarray(Image.open(f)) for f in sorted(d.iterdir())}


def _printed(capsys):
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith(("running", "TE-CAMO"))]


def test_cli_eval_on_ucod_dpl_dinov1_takes_the_fixed_box_as_jax_does(tmp_path, capsys):
    """``cli eval -c`` over configs/uscod/UCOD-DPL_dinov1.py (296px, LookTwice
    gate 0.05, feature size 68), float32, with a decoder whose first pass
    marks no pixel: every image takes the fixed box, past the 296px edge,
    and its crop pass through the backbone.  The port's masks are the JAX
    package's, pixel for pixel, and its printed metrics the same."""
    from ucod_dpl_tpu import cli as JCLI
    from ucod_dpl_tpu_torch import cli as TCLI
    from ucod_dpl_tpu_torch.config import CfgNode
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint

    _entry_world(tmp_path, ["TE-CAMO"])
    fe = FeatureExtractor(CfgNode({"type": "dinov1", "backbone": "facebook/dino-vitb8",
                                   "backbone_weights": str(tmp_path / "hf"), "arch": dict(NARROW)}), device="cpu")
    paths = sorted((tmp_path / "RefCOD" / "TE-CAMO" / "im").iterdir())
    feats = torch.from_numpy(fe.extract(load_image_batch_transform(paths, (296, 296))))
    dec = TB.init_rev_decoder(1, 128)
    fg = TB.rev_decoder_forward_resized(dec, feats, 68)[0]
    # just above the first pass's largest logit: no component, the fixed box
    dec = dec._replace(conv_out_fg_b=dec.conv_out_fg_b - fg.max() - 0.05)
    ckpt = str(tmp_path / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, dec, TB.init_rev_decoder(2, 128))
    results, lines = {}, {}
    for tag, main, extra in (("jax", JCLI.eval_main, []), ("port", TCLI.eval_main, ["--device", "cpu"])):
        cfg = _config_over(tmp_path, "UCOD-DPL_dinov1.py", tag, tpu_cfg={"compute_dtype": "float32"})
        results[tag] = main([*cfg, "--load_from", ckpt, "--datasets", "TE-CAMO", *extra, *_log_opts(tmp_path, tag)])
        lines[tag] = _printed(capsys)
    assert len(lines["port"]) == 2 and lines["port"] == lines["jax"], lines
    runner = results["port"]["TE-CAMO"]
    assert runner.feature_extractor.config.patch_size == 8 and runner.evaluator.img_size == (296, 296)
    assert runner.evaluator.look_twice_th == 0.05 and runner.evaluator.crops == 2  # one fixed box an image
    got, want = _preds(tmp_path / "logs_port", "TE-CAMO"), _preds(tmp_path / "logs_jax", "TE-CAMO")
    assert sorted(got) == sorted(want) and len(got) == 2
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
    assert all(m.any() for m in got.values())  # the pasted crops mark pixels the first pass did not


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_predictor_from_ucod_dpl_dinov1_matches_jax(tmp_path, monkeypatch, quantize):
    """``Predictor.from_config`` over configs/uscod/UCOD-DPL_dinov1.py (296px,
    feature size 68) on both packages, float32 (the JAX kernels in interpret
    mode): soft masks of 2 images within 1e-4 (the logits' f32 tolerance,
    2e-4 / 2e-5, through a sigmoid), and with ``quantize="int8"`` within
    0.05; the binary masks agreeing on 99.9% of the pixels (a float32 logit
    at the threshold may fall either way, tests/test_torch_eval.py's rule),
    99% with int8."""
    from ucod_dpl_tpu.serving import Predictor as JPredictor
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
    from ucod_dpl_tpu_torch.serving import Predictor as TPredictor

    _entry_world(tmp_path, ["TE-CAMO"])
    ckpt = str(tmp_path / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, TB.init_rev_decoder(1, 128), TB.init_rev_decoder(2, 128))
    cfg = _config_over(tmp_path, "UCOD-DPL_dinov1.py", "serve")[1]
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    got = TPredictor.from_config(cfg, ckpt, device="cpu", quantize=quantize)
    want = JPredictor.from_config(cfg, ckpt, quantize=quantize)
    assert got.image_size == (296, 296) and got.feature_size == 68 and got.quantize == quantize
    assert got.fe.config == TD.DinoConfig(**dataclasses.asdict(dataclasses.replace(
        JD.DinoConfig.dinov1_vitb8(), **NARROW)))
    paths = [str(p) for p in sorted((tmp_path / "RefCOD" / "TE-CAMO" / "im").iterdir())]
    for g, w in zip(got.predict(paths, soft=True), want.predict(paths, soft=True)):
        assert g.shape == (296, 296)
        np.testing.assert_allclose(g, w, atol=1e-4 if quantize is None else 0.05)
    for g, w in zip(got.predict(paths), want.predict(paths)):
        assert np.mean(g == w) >= (0.999 if quantize is None else 0.99)


def test_cli_lt_eval_and_lt_train_on_coral_dinov1_match_jax(tmp_path, capsys):
    """``cli lt_eval`` and ``cli lt_train`` over configs/uscod/CORAL_dinov1.py
    (296px, m-patches in val and train at 432px: L 2917, lr 2e-4, batch 2),
    window length narrowed to 8, float32: the m-patch caches, the masks
    pixel for pixel, and after one epoch the
    refiner and its EMA within rtol 1e-4 / atol 5e-6 of the JAX package's
    (tests/test_torch_coral.py's tolerances); the printed lines the same."""
    from test_torch_coral import _assert_refiners_close

    from ucod_dpl_tpu import cli as JCLI
    from ucod_dpl_tpu.models import udlr as JU
    from ucod_dpl_tpu_torch import cli as TCLI
    from ucod_dpl_tpu_torch.models import udlr as TU
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint

    _entry_world(tmp_path, ["TE-CAMO", "TR-CAMO", "TR-COD10K"])
    dec = TB.init_rev_decoder(1, 128)
    ckpt = str(tmp_path / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, dec, TB.init_rev_decoder(2, 128))
    refiner = str(tmp_path / "refiner.safetensors")
    JU.save_refiner_checkpoint(refiner, _np(JU.init_sparse_refiner(jax.random.PRNGKey(9), dim=128)))
    runs, lines = {}, {}
    for tag, main, extra in (("jax", JCLI.lt_eval_main, []), ("port", TCLI.lt_eval_main, ["--device", "cpu"])):
        cfg = _config_over(tmp_path, "CORAL_dinov1.py", tag, model_cfg={"window_length": 8},
                           tpu_cfg={"compute_dtype": "float32"})
        runs[tag] = main([*cfg, "--load_from", ckpt, "--refiner_path", refiner, "--datasets", "TE-CAMO", *extra,
                          *_log_opts(tmp_path, tag)])
        lines[tag] = _printed(capsys)
    assert len(lines["port"]) == 2 and lines["port"] == lines["jax"], lines
    runner = runs["port"]["TE-CAMO"]
    ds = runner.val_dataset
    assert ds.require_m_patches and ds._fe_image_size() == (432, 432)
    assert ds.caches.get("m_patch").read(0).shape == (4, 36, 36, 128)
    got, want = _preds(tmp_path / "logs_port", "TE-CAMO"), _preds(tmp_path / "logs_jax", "TE-CAMO")
    assert sorted(got) == sorted(want) and len(got) == 2
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])

    ckp = {}
    for tag, main, extra in (("jax", JCLI.lt_train_main, []), ("port", TCLI.lt_train_main, ["--device", "cpu"])):
        cfg = _config_over(tmp_path, "CORAL_dinov1.py", f"train_{tag}", model_cfg={"window_length": 8},
                           tpu_cfg={"compute_dtype": "float32"}, train_cfg={"max_epoch": 1})
        out = main([*cfg, "--load_from", ckpt, "--refiner_path", refiner, *extra,
                    *_log_opts(tmp_path, f"train_{tag}")])
        ckp[tag] = tmp_path / f"logs_train_{tag}" / "refiner_ckp"
    loop = out.train_loop
    assert out.train_dataset.require_m_patches and loop.lr == pytest.approx(2e-4)
    assert len(out.train_dataset) == 4 and np.isfinite(loop.epoch_losses).all()
    for f in ("epoch1.safetensors", "epoch1_ema.safetensors"):
        _assert_refiners_close(TU.load_refiner_checkpoint(str(ckp["port"] / f)),
                               JU.load_refiner_checkpoint(str(ckp["jax"] / f)), f)
