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
