"""Port K1 module (ucod_dpl_tpu_torch/ops/attention.py) against the JAX package.

The same numpy inputs go through the port's plain attention (what a CPU
tensor runs) and through the JAX packed Pallas kernel in interpret mode and
the JAX XLA attention.  Tolerances are those of tests/test_dino_parity.py:
1e-5 in float32, 0.05 in bf16 against the float32 reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ucod_dpl_tpu.ops import attention as A
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.ops import attention as TA


def _qkv(seed, b, l, d, q_rows_scaled=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, d)).astype(np.float32) for _ in range(3))
    # rows with logits far from zero (|s| ~ 24 natural units at scale 1/8)
    q[:, :q_rows_scaled] *= 3.0
    return q, k, v


def _jax_xla(q, k, v, nh, scale):
    b, l, d = q.shape
    hd = d // nh

    def split(x):
        return jnp.asarray(x).reshape(b, l, nh, hd).transpose(0, 2, 1, 3).reshape(b * nh, l, hd)

    ref = A._xla_attention(split(q), split(k), split(v), scale=scale)
    return np.asarray(ref).reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, d)


def _port(q, k, v, nh, scale, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return TA.packed_attention(*t, nh, scale).float().numpy()


@pytest.mark.parametrize(
    "b,l,nh",
    [
        (2, 150, 4),  # L not a multiple of 64
        (2, 257, 2),  # the 224px pseudo-label length
        (1, 1370, 12),  # the 518px serving geometry: D = 768, 12 heads
    ],
)
def test_plain_attention_matches_jax_pallas_and_xla_f32(b, l, nh):
    q, k, v = _qkv(b * l, b, l, nh * 64)
    ours = _port(q, k, v, nh, 0.125)
    np.testing.assert_allclose(ours, _jax_xla(q, k, v, nh, 0.125), rtol=1e-5, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(A._pallas_attention_packed(*(jnp.asarray(x) for x in (q, k, v)), nh, 0.125))
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)


def test_plain_attention_bf16_large_logits():
    """bf16 inputs with rows of large logits: within bf16 rounding of the
    float32 JAX reference, and finite."""
    q, k, v = _qkv(11, 2, 150, 256, q_rows_scaled=10)
    ours = _port(q, k, v, 4, 0.125, torch.bfloat16)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, _jax_xla(q, k, v, 4, 0.125), rtol=0.05, atol=0.05)


def test_odd_head_count_matches_jax_per_head_kernel():
    """An odd head count takes the JAX per-head-layout kernel (K5); the port's
    one attention covers it."""
    q, k, v = _qkv(5, 2, 200, 3 * 64)
    b, l, nh, hd = 2, 200, 3, 64

    def split(x):
        return jnp.asarray(x).reshape(b, l, nh, hd).transpose(0, 2, 1, 3).reshape(b * nh, l, hd)

    with pltpu.force_tpu_interpret_mode():
        o = np.asarray(A._pallas_attention(split(q), split(k), split(v), 0.125, block_q=128))
    o = o.reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, nh * hd)
    np.testing.assert_allclose(_port(q, k, v, nh, 0.125), o, rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_routes_cpu_to_plain_and_counts_only_launches():
    q = torch.randn(1, 70, 128)
    before = TA.packed_attention.launches
    out = torch.full_like(q, float("nan"))
    got = TA.packed_attention(q, q, q, 2, 0.125, out=out)
    assert got is out
    torch.testing.assert_close(got, TA.packed_attention_reference(q, q, q, 2, 0.125))
    assert TA.packed_attention.launches == before  # a CPU tensor launches nothing


# --- K5 and the JAX dispatch: multi_head_attention --------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 65, 200])
@pytest.mark.parametrize("nh,hd", [(3, 64), (5, 32), (4, 16), (1, 64), (2, 64), (2, 128), (3, 128), (3, 16),
                                   (3, 32)])
def test_multi_head_attention_matches_jax_dispatch(monkeypatch, nh, hd, l, dtype):
    """The port's multi_head_attention (on the CPU the plain versions of the
    JAX dispatch's routes: K1's for an even count of 64, else the per-head
    K5's) and the plain version of the card's route, the forward on the
    packed layout at any head count (``packed_attention_reference``), against
    the JAX multi_head_attention with its Pallas kernels in interpret mode
    (the packed kernel for (2, 64) and (2, 128), the per-head K5 for the
    rest): f32 within 1e-5, bf16 within 0.05 of the f32 JAX output."""
    q, k, v = _qkv(31 * nh + l + hd, 2, l, nh * hd, q_rows_scaled=min(l, 3))
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = np.asarray(A.multi_head_attention(*(jnp.asarray(x) for x in (q, k, v)), nh, scale=hd ** -0.5))
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    tol = 1e-5 if dtype == torch.float32 else 0.05
    for got in (TA.multi_head_attention(*t, nh, hd ** -0.5), TA.packed_attention_reference(*t, nh, hd ** -0.5)):
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, _jax_xla(q, k, v, nh, hd ** -0.5), rtol=tol, atol=tol)


@pytest.mark.parametrize("nh,hd,jax_packed,packed", [(2, 64, True, True), (12, 64, True, True),
                                                     (3, 64, False, True), (4, 32, False, True),
                                                     (2, 128, True, True), (1, 16, False, True),
                                                     (5, 128, False, True)])
def test_multi_head_attention_routes_like_jax(monkeypatch, nh, hd, jax_packed, packed):
    """``packed_layout_ok`` is the JAX rule, and the CPU's plain routes follow
    it: K1's plain version for an even head count of 64, the per-head K5's
    for the rest; the CPU launches no kernel.  ``packed``: the card's route
    takes the heads to ``packed_attention`` as they are, no split (seen here
    through a tensor on the meta device, which takes the card's route and
    which no kernel takes)."""
    assert TA.packed_layout_ok(nh, hd) is jax_packed
    calls = []
    for name, kernel in (("packed_attention_reference", "K1"), ("heads_attention_reference", "K5")):
        plain = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _p=plain, _k=kernel: calls.append(_k) or _p(*a))
    q = torch.randn(1, 9, nh * hd)
    before = (TA.packed_attention.launches, TA.heads_attention.launches)
    TA.multi_head_attention(q, q, q, nh, 0.125)
    assert calls == ["K1" if jax_packed and hd == 64 else "K5"]
    assert (TA.packed_attention.launches, TA.heads_attention.launches) == before

    card = []
    monkeypatch.setattr(TA, "packed_attention", lambda q, k, v, nh, scale: card.append((q.shape, nh)) or q)
    m = torch.empty(2, 9, nh * hd, device="meta")
    assert (TA.multi_head_attention(m, m, m, nh, 0.125) is m) is packed
    assert card == ([((2, 9, nh * hd), nh)] if packed else []) and len(calls) == 1


@pytest.mark.parametrize("nh,hd,route", [(2, 64, "flash"), (2, 128, "flash"), (3, 64, "plain"), (4, 32, "plain")])
def test_differentiable_forward_routes_like_jax_differentiable_mode(monkeypatch, nh, hd, route):
    """The JAX differentiable_mode's routing: an even head count with
    2 * hd % 128 == 0 through the flash VJP (``packed_attention_diff``, on
    the CPU its plain versions, for any head dim), the rest through the plain
    version under autograd (the JAX ``_xla_attention``)."""
    calls = []
    # the routing lives in ops.attention.differentiable_attention
    monkeypatch.setattr(TA, "packed_attention_diff",
                        lambda *a, _p=TA.packed_attention_diff: calls.append("flash") or _p(*a))
    monkeypatch.setattr(TA, "multi_head_attention",
                        lambda *a, _p=TA.multi_head_attention, **kw: calls.append("plain") or _p(*a, **kw))
    cfg = TD.DinoConfig(variant="dinov2", image_size=28, patch_size=14, hidden_size=nh * hd, num_layers=2,
                        num_heads=nh, mlp_ratio=2)
    out = TD.dino_forward(TD.init_dino(0, cfg), torch.randn(1, 28, 28, 3), cfg, differentiable=True)
    assert calls == [route]
    assert torch.isfinite(out["key_features"]).all()


def test_heads_attention_wrapper_routes_cpu_to_plain():
    q = torch.randn(6, 70, 32)
    before = TA.heads_attention.launches
    out = torch.full_like(q, float("nan"))
    got = TA.heads_attention(q, q, q, 0.2, out=out)
    assert got is out
    torch.testing.assert_close(got, TA.heads_attention_reference(q, q, q, 0.2))
    assert TA.heads_attention.launches == before
