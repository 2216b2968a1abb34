"""The port's differentiable attention against the JAX package's custom VJP.

The same numpy inputs go through the port's ``packed_attention_diff`` (on the
CPU: the plain forward with log-sum-exp and the plain flash backward) and
through the JAX ``_packed_attention_diff`` with its Pallas kernels in
interpret mode: the whole-KV backward (K3) at the lengths the JAX package
takes it, and the KV-blocked backward from saved denominators (K4), forced
as ``tests/test_attention_vjp.py`` forces it.  Float32, at the tolerances of
``tests/test_attention_vjp.py`` (rtol 2e-4, atol 2e-5).  Also: the port's
log-sum-exp against K2's saved denominators.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.ops import attention as A
from ucod_dpl_tpu_torch.ops import attention as TA


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")


def _inputs(seed, b, l, nh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, nh * 64)).astype(np.float32) for _ in range(3)]


def _jax_grads(q, k, v, nh, scale):
    def loss(*a):
        return jnp.sum(A._packed_attention_diff(*a, nh, scale, False) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))]


def _port_grads(q, k, v, nh, scale):
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    torch.sum(TA.packed_attention_diff(*t, nh, scale) ** 2).backward()
    return [x.grad.numpy() for x in t]


def _assert_grads_match(q, k, v, nh):
    scale = 1.0 / np.sqrt(64)
    for name, got, want in zip("qkv", _port_grads(q, k, v, nh, scale), _jax_grads(q, k, v, nh, scale)):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=f"d{name}")


# 150 exercises a boundary block (not a multiple of 128), 128 the aligned
# path, 12 heads ViT-B: the JAX VJP takes K3 at these lengths
@pytest.mark.parametrize("seq_len,num_heads", [(150, 2), (128, 2), (90, 12)])
def test_grads_match_jax_whole_kv_backward(seq_len, num_heads):
    assert A._bwd_block_q(A._ceil_to(seq_len, 128), 4) is not None  # K3, not K4
    _assert_grads_match(*_inputs(seq_len, 2, seq_len, num_heads), num_heads)


@pytest.mark.parametrize("seq_len,num_heads", [(150, 2), (256, 12)])
def test_grads_match_jax_kv_blocked_backward(seq_len, num_heads, monkeypatch):
    """The JAX stats forward (K2) + KV-blocked backward (K4), forced at small L
    by making the whole-KV VMEM law refuse, as 756px engages it on the TPU."""
    monkeypatch.setattr(A, "_bwd_block_q", lambda lp, itemsize: None)
    jax.clear_caches()
    try:
        _assert_grads_match(*_inputs(seq_len + 7, 2, seq_len, num_heads), num_heads)
    finally:
        jax.clear_caches()  # drop programs traced under the patched law


def test_lse_matches_jax_stats_denominators():
    """lse = ln sum exp(scale q.k) equals ln(den) + 30 ln 2 for K2's saved
    den = sum exp2(scale log2(e) q.k - 30), and the outputs agree."""
    b, l, nh = 2, 150, 2
    q, k, v = _inputs(9, b, l, nh)
    scale = 1.0 / np.sqrt(64)
    o_j, den = A._pallas_attention_packed_stats(*(jnp.asarray(x) for x in (q, k, v)), nh, scale)
    o_t, lse = TA.packed_attention_fwd_lse(*(torch.from_numpy(x) for x in (q, k, v)), nh, scale)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, nh, l)
    den = np.asarray(den)
    for h in range(nh):
        want = np.log(den[:, h // 2, :, 4 * (h % 2)].astype(np.float64)) + A._SOFTMAX_SHIFT * np.log(2.0)
        np.testing.assert_allclose(lse[:, h].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The flash algebra from the saved log-sum-exp equals autograd through
    the plain forward (f32)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 2, 70, 4))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(q.shape).astype(np.float32))
    o, lse = TA.packed_attention_fwd_lse_reference(q, k, v, 4, 0.125)
    got = TA.packed_attention_bwd_reference(q, k, v, o, do, lse, 4, 0.125)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(TA.packed_attention_reference(*leaves, 4, 0.125), leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_take_plain_versions_count_nothing_and_keep_dtype():
    q, k, v = (torch.randn(1, 70, 128, dtype=torch.bfloat16, requires_grad=True) for _ in range(3))
    before = (TA.packed_attention_fwd_lse.launches, TA.packed_attention_bwd.launches)
    o = TA.packed_attention_diff(q, k, v, 2, 0.125)
    torch.testing.assert_close(o, TA.packed_attention_reference(q, k, v, 2, 0.125), rtol=0, atol=0)
    o.float().sum().backward()
    assert (TA.packed_attention_fwd_lse.launches, TA.packed_attention_bwd.launches) == before
    for x in (q, k, v):
        assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    out = (torch.full_like(q, float("nan")), torch.full((1, 2, 70), float("nan")))
    got = TA.packed_attention_fwd_lse(q.detach(), k.detach(), v.detach(), 2, 0.125, out=out)
    assert got[0] is out[0] and got[1] is out[1] and torch.isfinite(got[1]).all()


@pytest.mark.parametrize("kv_len", [1, 5, 63, 64, 65, 67])
def test_plain_versions_with_a_key_bound_equal_dense_attention_on_the_valid_keys(kv_len):
    """``kv_len``: the plain forward with log-sum-exp and the plain backward
    over the keys [0, kv_len) equal dense attention (and its autograd) on
    those keys alone; dk/dv rows past the bound are exact zeros; an f32
    ``out_dtype`` from bf16 inputs keeps the unrounded values."""
    b, l, nh, scale = 2, 70, 2, 0.125
    q, k, v = (torch.from_numpy(x) for x in _inputs(kv_len, b, l, nh))
    do = torch.from_numpy(np.random.default_rng(kv_len + 1).standard_normal(q.shape).astype(np.float32))
    o, lse = TA.packed_attention_fwd_lse_reference(q, k, v, nh, scale, kv_len=kv_len)
    leaves = [q.clone().requires_grad_(True), k[:, :kv_len].clone().requires_grad_(True),
              v[:, :kv_len].clone().requires_grad_(True)]
    qh, kh, vh = (x.reshape(b, x.shape[1], nh, 64) for x in leaves)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vh).reshape(b, l, nh * 64)
    torch.testing.assert_close(o, dense.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1).detach(), rtol=1e-5, atol=1e-5)
    dq, dk, dv = TA.packed_attention_bwd_reference(q, k, v, o, do, lse, nh, scale, kv_len=kv_len)
    want = torch.autograd.grad(dense, leaves, do)
    torch.testing.assert_close(dq, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dk[:, :kv_len], want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv[:, :kv_len], want[2], rtol=1e-5, atol=1e-5)
    assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()
    # the CPU wrappers take the same plain versions
    got = TA.packed_attention_fwd_lse(q, k, v, nh, scale, kv_len=kv_len)
    assert torch.equal(got[0], o) and torch.equal(got[1], lse)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    o32, _ = TA.packed_attention_fwd_lse(qb, kb, vb, nh, scale, kv_len=kv_len, out_dtype=torch.float32)
    o16, _ = TA.packed_attention_fwd_lse(qb, kb, vb, nh, scale, kv_len=kv_len)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(torch.bfloat16), o16)
    g32 = TA.packed_attention_bwd(qb, kb, vb, o16, do.to(torch.bfloat16), lse, nh, scale, kv_len=kv_len,
                                  out_dtype=torch.float32)
    assert all(g.dtype == torch.float32 for g in g32)
    for bad in (0, l + 1):
        with pytest.raises(ValueError, match="kv_len"):
            TA.packed_attention_fwd_lse(q, k, v, nh, scale, kv_len=bad)
        with pytest.raises(ValueError, match="kv_len"):
            TA.packed_attention_bwd(q, k, v, o, do, lse, nh, scale, kv_len=bad)
