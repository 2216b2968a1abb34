"""Port K6 module (ucod_dpl_tpu_torch/ops/fused_layers.py) and the resize ops
against the JAX package, on the same numpy inputs.

K6's plain version is held to JAX ``layernorm_qkv`` run through its Pallas
kernel in interpret mode (UCOD_PALLAS_INTERPRET=1) at 1e-5 in float32, as in
tests/test_dino_parity.py.  The resize ops are held to the JAX weight-matrix
resizes and to torch's own ``F.interpolate``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ucod_dpl_tpu.ops import fused_layers as JF
from ucod_dpl_tpu.ops import resize as JR
from ucod_dpl_tpu_torch.ops import fused_layers as TF
from ucod_dpl_tpu_torch.ops import resize as TR


@pytest.mark.parametrize("b,l,d", [(2, 150, 128), (1, 70, 256), (1, 257, 768)])
def test_plain_layernorm_qkv_matches_jax_kernel(monkeypatch, b, l, d):
    rng = np.random.default_rng(7 + d)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    norm = {"scale": rng.standard_normal(d).astype(np.float32),
            "bias": rng.standard_normal(d).astype(np.float32)}
    lins = [{"w": rng.standard_normal((d, d)).astype(np.float32) * 0.05,
             "b": rng.standard_normal(d).astype(np.float32)} for _ in range(3)]

    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = JF.layernorm_qkv(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in norm.items()},
        *({k: jnp.asarray(v) for k, v in p.items()} for p in lins), 1e-6,
    )
    t_norm = {k: torch.from_numpy(v) for k, v in norm.items()}
    t_lins = [{"w": torch.from_numpy(p["w"].T.copy()), "b": torch.from_numpy(p["b"])} for p in lins]
    got = TF.layernorm_qkv(torch.from_numpy(x), t_norm, *t_lins, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_routes_cpu_to_plain():
    x = torch.randn(2, 5, 128)
    norm = {"scale": torch.ones(128), "bias": torch.zeros(128)}
    lin = {"w": torch.randn(128, 128), "b": torch.randn(128)}
    before = TF.layernorm_qkv.launches
    outs = tuple(torch.empty_like(x) for _ in range(3))
    got = TF.layernorm_qkv(x, norm, lin, lin, lin, 1e-6, out=outs)
    assert all(g is o for g, o in zip(got, outs))
    for g, r in zip(got, TF.layernorm_qkv_reference(x, norm, lin, lin, lin, 1e-6)):
        torch.testing.assert_close(g, r)
    assert TF.layernorm_qkv.launches == before


@pytest.mark.parametrize(
    "shape,size",
    [((2, 37, 37, 3), (68, 68)), ((1, 68, 68, 1), (518, 518)), ((2, 5, 7, 4), (3, 9)), ((1, 1, 6, 2), (4, 4))],
)
def test_bilinear_nhwc_matches_jax_and_torch(shape, size):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = TR.interpolate_bilinear_nhwc(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(JR.interpolate_bilinear_nhwc(jnp.asarray(x), size)),
                               rtol=1e-5, atol=1e-6)
    torch_ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=size, mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1).numpy()
    # torch interpolates with two taps directly: f32 rounding differs from
    # the matmul form (the tolerance tests/test_resize_ops.py uses)
    np.testing.assert_allclose(got, torch_ref, rtol=1e-4, atol=5e-5)
    chw = np.transpose(x, (0, 3, 1, 2))
    np.testing.assert_allclose(TR.interpolate_bilinear_np(chw, size), JR.interpolate_bilinear_np(chw, size),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grid,size", [(37, (52, 52)), (37, (37, 50)), (16, (8, 12))])
def test_bicubic_matches_jax_and_torch(grid, size):
    x = np.random.default_rng(2).standard_normal((1, 8, grid, grid)).astype(np.float32)
    got = TR.interpolate_bicubic(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(JR.interpolate_bicubic(jnp.asarray(x), size)),
                               rtol=1e-5, atol=1e-5)
    torch_ref = F.interpolate(torch.from_numpy(x), size=size, mode="bicubic", align_corners=False).numpy()
    np.testing.assert_allclose(got, torch_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,l,d,f", [(2, 150, 128, 512), (1, 70, 256, 256), (3, 1, 128, 512), (2, 37, 768, 3072)])
def test_plain_layernorm_fc1_gelu_matches_jax_kernel(monkeypatch, b, l, d, f):
    """K7's plain version against the JAX ``_pallas_layernorm_fc1_gelu`` in
    interpret mode (the shapes of tests/test_dino_parity.py's fused-op test
    first, then the serving widths 768 -> 3072), float32 within 1e-5."""
    rng = np.random.default_rng(11 + d + l)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    norm = {"scale": rng.standard_normal(d).astype(np.float32),
            "bias": rng.standard_normal(d).astype(np.float32)}
    fc1 = {"w": rng.standard_normal((d, f)).astype(np.float32) * 0.05,
           "b": rng.standard_normal(f).astype(np.float32)}
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = JF._pallas_layernorm_fc1_gelu(
        jnp.asarray(x), jnp.asarray(norm["scale"]).reshape(1, d), jnp.asarray(norm["bias"]).reshape(1, d),
        jnp.asarray(fc1["w"]), jnp.asarray(fc1["b"]).reshape(1, f), 1e-6,
    )
    got = TF.layernorm_fc1_gelu(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in norm.items()},
                                {"w": torch.from_numpy(fc1["w"].T.copy()), "b": torch.from_numpy(fc1["b"])}, 1e-6)
    assert got.shape == (b, l, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_layernorm_fc1_gelu_bf16_rounds_where_the_kernel_does():
    """In bf16 the plain version rounds h, then fc1 + b1, then the GELU
    output: it equals the f32 composition of those three roundings."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 128, generator=g).to(torch.bfloat16)
    norm = {"scale": 1 + 0.1 * torch.randn(128, generator=g), "bias": 0.1 * torch.randn(128, generator=g)}
    fc1 = {"w": torch.randn(256, 128, generator=g) / 128 ** 0.5, "b": 0.1 * torch.randn(256, generator=g)}
    got = TF.layernorm_fc1_gelu(x, norm, fc1, 1e-6)
    h = TF._layernorm_f32(x, norm, 1e-6).to(torch.bfloat16).float()
    h1 = (h @ fc1["w"].T + fc1["b"]).to(torch.bfloat16).float()
    want = (h1 * 0.5 * (1 + torch.tanh(0.7978845608028654 * (h1 + 0.044715 * h1 ** 3)))).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -7 * want.float().abs().max().item())


def test_layernorm_fc1_gelu_wrapper_routes_cpu_to_plain():
    x = torch.randn(2, 5, 128)
    norm = {"scale": torch.ones(128), "bias": torch.zeros(128)}
    fc1 = {"w": torch.randn(256, 128), "b": torch.randn(256)}
    before = TF.layernorm_fc1_gelu.launches
    out = torch.full((2, 5, 256), float("nan"))
    got = TF.layernorm_fc1_gelu(x, norm, fc1, 1e-6, out=out)
    assert got is out
    torch.testing.assert_close(got, TF.layernorm_fc1_gelu_reference(x, norm, fc1, 1e-6))
    assert TF.layernorm_fc1_gelu.launches == before
