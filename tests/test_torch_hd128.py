"""The port's differentiated attention at head dim 128 against the JAX package.

The JAX forward with statistics (K2, ``_pallas_attention_packed_stats``) and
flash backwards (K3 ``_pallas_attention_packed_bwd``, K4
``_pallas_attention_packed_bwd_longl``) take every even head count with
``2 * hd % 128 == 0``; the port's kernels take head dims 64 and 128.  On the
CPU the port's wrappers run their plain versions; the JAX kernels run in
interpret mode, as ``tests/test_attention_vjp.py`` runs them.  The same
numpy inputs go through both:

* K2's output and log-sum-exp (from its saved denominators) at a ragged L
  (150, not a multiple of the TPU's 128-row blocks), an aligned one and a
  short one; bf16 inputs with an f32 output against the kernel's bf16 run;
* the gradients of ``packed_attention_diff`` against ``jax.grad`` through
  ``_packed_attention_diff``, by the whole-KV backward (K3) and the
  KV-blocked one (K4, forced as the JAX tests force it);
* a key bound ``kv_len < L`` (a ring chunk ending in padding) against the
  JAX ring on one device with the padding masked (``valid``): the output,
  the log-sum-exp (numpy's of the masked scores) and the gradients;
* LoRA gradients (adapters and pixels) through ``lora_forward`` of a narrow
  ViT with 2 and 4 heads of 128 against ``jax.grad`` of the JAX
  ``lora_forward``;
* the route of ``packed_attention_diff``: a forward that autograd does not
  record runs K1's wrapper (``packed_attention``), as the JAX primal runs
  its plain kernel; one that it records runs K2's.

Tolerances: f32 1e-5; bf16 attention 0.05 (absolute, outputs of order 1);
gradients rtol 2e-4, atol 2e-5 (tests/test_attention_vjp.py's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu.ops import attention as A
from ucod_dpl_tpu.parallel import build_mesh as jax_build_mesh
from ucod_dpl_tpu.parallel.sp import ring_attention as jax_ring_attention
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.models.lora import lora_forward
from ucod_dpl_tpu_torch.ops import attention as TA

HD = 128
SCALE = 1.0 / np.sqrt(HD)
F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")


def _inputs(seed, b, l, nh, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, nh * HD)).astype(np.float32) for _ in range(n)]


def _jax_lse(den, nh):
    """K2's saved denominators (B, nh/2, L, 8) -> the natural-log lse."""
    den = np.asarray(den)
    return np.stack([np.log(den[:, h // 2, :, 4 * (h % 2)].astype(np.float64)) + A._SOFTMAX_SHIFT * np.log(2.0)
                     for h in range(nh)], axis=1)


@pytest.mark.parametrize("seq_len,num_heads", [(150, 2), (128, 4), (37, 2)])
def test_forward_with_lse_matches_jax_stats_kernel(seq_len, num_heads):
    q, k, v = _inputs(seq_len, 2, seq_len, num_heads)
    o_j, den = A._pallas_attention_packed_stats(*(jnp.asarray(x) for x in (q, k, v)), num_heads, SCALE)
    o_t, lse = TA.packed_attention_fwd_lse(*(torch.from_numpy(x) for x in (q, k, v)), num_heads, SCALE)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, num_heads, seq_len)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(den, num_heads), **F32)


def test_bf16_forward_with_an_f32_output_matches_jax_kernel():
    """bf16 inputs: the f32 output (a ring's partial) rounds to the bf16 one
    bit for bit, and both are within the bf16 bound of the JAX kernel's
    bf16 run."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(5, 2, 150, 2))
    o32, lse32 = TA.packed_attention_fwd_lse(q, k, v, 2, SCALE, out_dtype=torch.float32)
    o16, lse16 = TA.packed_attention_fwd_lse(q, k, v, 2, SCALE)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    assert torch.equal(o32.to(torch.bfloat16), o16) and torch.equal(lse32, lse16)
    o_j, den = A._pallas_attention_packed_stats(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                                                2, SCALE)
    np.testing.assert_allclose(o32.numpy(), np.asarray(o_j, np.float32), atol=0.05, rtol=0)
    np.testing.assert_allclose(lse32.numpy(), _jax_lse(den, 2), atol=0.05, rtol=0)


def _jax_grads(q, k, v, nh):
    def loss(*a):
        return jnp.sum(A._packed_attention_diff(*a, nh, float(SCALE), False) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))]


def _port_grads(q, k, v, nh):
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    torch.sum(TA.packed_attention_diff(*t, nh, SCALE) ** 2).backward()
    return [x.grad.numpy() for x in t]


@pytest.mark.parametrize("seq_len,num_heads", [(150, 2), (128, 2), (37, 4)])
def test_grads_match_jax_whole_kv_backward(seq_len, num_heads):
    assert A._bwd_block_q(A._ceil_to(seq_len, 128), 4) is not None  # K3, not K4
    q, k, v = _inputs(seq_len + 1, 2, seq_len, num_heads)
    for name, got, want in zip("qkv", _port_grads(q, k, v, num_heads), _jax_grads(q, k, v, num_heads)):
        np.testing.assert_allclose(got, want, err_msg=f"d{name}", **GRAD)


@pytest.mark.parametrize("seq_len,num_heads", [(150, 2), (130, 2)])
def test_grads_match_jax_kv_blocked_backward(seq_len, num_heads, monkeypatch):
    """The JAX stats forward (K2) + KV-blocked backward (K4), forced at small
    L by making the whole-KV VMEM law refuse, as 756px engages it on the
    TPU."""
    monkeypatch.setattr(A, "_bwd_block_q", lambda lp, itemsize: None)
    jax.clear_caches()
    try:
        q, k, v = _inputs(seq_len + 2, 2, seq_len, num_heads)
        for name, got, want in zip("qkv", _port_grads(q, k, v, num_heads), _jax_grads(q, k, v, num_heads)):
            np.testing.assert_allclose(got, want, err_msg=f"d{name}", **GRAD)
    finally:
        jax.clear_caches()  # drop programs traced under the patched law


@pytest.mark.parametrize("l,kv_len", [(40, 37), (64, 1), (150, 129)])
def test_key_bound_matches_jax_ring_with_padding(l, kv_len):
    """``kv_len``: the keys past it take no part, as the JAX ring's padding
    mask (``valid``) on one device: output, log-sum-exp and gradients;
    dk/dv rows past the bound exact zeros (JAX's padded keys get none)."""
    nh, b = 2, 2
    q, k, v, w = _inputs(l + kv_len, b, l, nh, n=4)
    jmesh = jax_build_mesh({"seq": 1}, devices=jax.devices()[:1])
    valid = jnp.broadcast_to(jnp.arange(l) < kv_len, (b, l))

    def ring(q, k, v):
        return jax_ring_attention(q, k, v, nh, scale=float(SCALE), mesh=jmesh, axis="seq", valid=valid)

    want = np.asarray(jax.jit(ring)(q, k, v))
    want_g = jax.jit(jax.grad(lambda *a: jnp.sum(ring(*a) * w), argnums=(0, 1, 2)))(q, k, v)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = TA.packed_attention_fwd_lse(*t, nh, SCALE, kv_len=kv_len)
    np.testing.assert_allclose(o.numpy(), want, **F32)
    s = np.einsum("bqhd,bkhd->bhqk", *(x.reshape(b, l, nh, HD).astype(np.float64) for x in (q, k))) * SCALE
    s = s[..., :kv_len]
    m = s.max(-1, keepdims=True)
    np.testing.assert_allclose(lse.numpy(), (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0], **F32)
    grads = TA.packed_attention_bwd(*t, o, torch.from_numpy(w), lse, nh, SCALE, kv_len=kv_len)
    for name, got, wg in zip("qkv", grads, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(wg), err_msg=f"d{name}", **GRAD)
    assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()


@pytest.mark.parametrize("num_heads", [2, 4])
def test_lora_grads_through_the_backbone_match_jax(num_heads):
    """Adapter and pixel gradients of ``sum(key_features * w)`` through
    ``lora_forward`` (the differentiated forward: packed_attention_diff at
    head dim 128) of a 2-layer ViT with ``num_heads`` heads of 128, against
    jax.grad through the JAX ``lora_forward`` (its flash VJP kernels in
    interpret mode), the adapters' B nonzero so that every gradient is
    live."""
    arch = dict(image_size=28, patch_size=14, hidden_size=num_heads * HD, num_layers=2, num_heads=num_heads,
                mlp_ratio=2)
    jcfg = JD.DinoConfig(variant="dinov2", use_layerscale=True, **arch)
    tcfg = TD.DinoConfig(variant="dinov2", use_layerscale=True, **arch)
    jp = JD.init_dino(jax.random.PRNGKey(num_heads), jcfg)
    jl = JL.init_lora(jax.random.PRNGKey(num_heads + 1), jp, rank=2)
    rng = np.random.default_rng(num_heads)
    jl = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.02), jl)
    px = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    w = rng.standard_normal((2, 2, 2, num_heads * HD)).astype(np.float32)

    def loss(lora, x):
        out = JL.lora_forward(jax.lax.stop_gradient(jp), lora, x, jcfg, rank=2, alpha=4.0)
        return jnp.sum(out["key_features"] * w)

    want_l, want_px = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(px))
    params = C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    lora = C.tree_map(lambda t: t.clone().requires_grad_(True), C.lora_from_jax(jax.tree_util.tree_map(np.asarray, jl)))
    x = torch.from_numpy(px).requires_grad_(True)
    before = TA.packed_attention_fwd_lse.launches
    out = lora_forward(params, lora, x, tcfg, rank=2, alpha=4.0)
    torch.sum(out["key_features"] * torch.from_numpy(w)).backward()
    assert TA.packed_attention_fwd_lse.launches == before  # the CPU runs the plain versions
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_px), **GRAD)
    want = C.lora_from_jax(jax.tree_util.tree_map(np.asarray, want_l))
    for i, (got_layer, want_layer) in enumerate(zip(lora, want)):
        for t in ("q", "k", "v"):
            for name in ("a", "b"):
                g = got_layer[t][name].grad
                g = torch.zeros_like(got_layer[t][name]) if g is None else g
                np.testing.assert_allclose(g.numpy(), want_layer[t][name].numpy(), err_msg=f"layer {i} {t}.{name}",
                                           **GRAD)


@pytest.mark.parametrize("hd", [64, 128])
def test_packed_attention_diff_runs_k1_when_autograd_records_nothing(monkeypatch, hd):
    """The JAX ``_packed_attention_diff`` primal runs its plain kernel (K1);
    only a differentiated call saves the statistics.  Under ``no_grad``, or
    with no input requiring grad, the port's ``packed_attention_diff`` calls
    ``packed_attention`` (K1's wrapper); with an input requiring grad it
    calls ``packed_attention_fwd_lse`` (K2's); the outputs are equal bit for
    bit."""
    calls = []
    for name in ("packed_attention", "packed_attention_fwd_lse"):
        orig = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _o=orig, _n=name, **kw: calls.append(_n) or _o(*a, **kw))
    q, k, v = (torch.randn(2, 37, 2 * hd) for _ in range(3))
    with torch.no_grad():
        o_nograd = TA.packed_attention_diff(q, k, v, 2, hd ** -0.5)
    o_plain = TA.packed_attention_diff(q, k, v, 2, hd ** -0.5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_grad = TA.packed_attention_diff(*leaves, 2, hd ** -0.5)
    assert calls == ["packed_attention", "packed_attention", "packed_attention_fwd_lse"]
    assert o_grad.requires_grad and not o_nograd.requires_grad
    assert torch.equal(o_nograd, o_plain) and torch.equal(o_nograd, o_grad.detach())
