"""Card-only checks of the port's CUDA kernels at edge shapes: the attention
forward (K1 at every head dim and head count, also with its log-sum-exp
output, and on the per-head layout, K5), the attention backward (also equal
bit for bit from call to call), both with a key bound and f32 outputs, at
head dims 64 and 128, and as the sequence-parallel ring, K6, K7
(LayerNorm + fc1 + GELU), the int8 kernels K8-K11 (K6, K8 and K9 also at
DINOv1's LayerNorm eps 1e-12 with a constant row, and K1 at its 224px
length 785), and the fusion
prototypes' ports K12 (attention + out-projection + layerscale + residual)
and K13 (the patch embed as one im2col GEMM); the K1 variants that port the
TPU attention prototypes (``tools/attention_ab.py``) and compute K1's
function, the constant-shift variant and the scale folded into q, against
their plain functions;
the eval entry
(``cli.eval_main``) at a small width, by its K1/K6 launches; the train
entry (``cli.train_main``, LoRA off and on) at a small width, by its
launches, losses and a preemption resumed bit for bit; and CORAL stage-2
training (``cli.lt_train_main``) at a small width, by its launches and two
runs equal bit for bit.

Marked ``cuda``: they skip without a CUDA device (the decision is made in a
fixture, at run time).  On a card::

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: K1 and K5 within 2^-6 * max|plain| of their
plain versions, K7 within 2% of max|plain|, the log-sum-exp within 1e-3, the backward's dq/dk/dv within
2^-5 * max|plain| and 2% of the plain gradient's norm (each plus a 1e-5
floor), K6 within 2% of max|plain|; the int8 kernels as in chip_smoke.py's
phase D: codes within one step and at least 99% equal, scales within rtol
1e-5, bf16 outputs, row by row, within one code step (s_x * 127 * max w_s) plus
one bf16 ulp of the row's max|plain|; K11 equal bit for bit to the split
kernel path (K9's kernel, then ``dense_w8a8_pre``); K12 within 2^-6 and K13
within 2^-7 of max|plain|.
"""

import os

import pytest
import torch

from ucod_dpl_tpu_torch.ops.attention import (
    heads_attention,
    heads_attention_reference,
    multi_head_attention,
    packed_attention,
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_diff,
    packed_attention_fwd_lse,
    packed_attention_fwd_lse_reference,
    packed_attention_reference,
)
from ucod_dpl_tpu_torch.ops import fused_layers as FL
from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_qkv, layernorm_qkv_reference
from ucod_dpl_tpu_torch.ops.quant import dense_w8a8_pre, quantize_act, quantize_linear
from ucod_dpl_tpu_torch.ops.attention import attention_outproj_residual, attention_outproj_residual_reference
from ucod_dpl_tpu_torch.ops.patch_embed import patch_embed, patch_embed_reference
from ucod_dpl_tpu_torch.tools import attention_ab as AB

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# L on both sides of the 64- and 128-row tile edges; 2, 6 (a model=2 shard
# of dinov2-base) and 16 heads
@pytest.mark.parametrize("b,l,nh", [(1, 1, 2), (2, 63, 2), (2, 65, 4), (3, 129, 6), (1, 5477, 12), (2, 128, 2),
                                    (2, 192, 16), (1, 193, 6), (2, 255, 2), (2, 256, 6), (1, 257, 16)])
def test_attention_kernel_edge_lengths(dev, b, l, nh):
    g = torch.Generator(device=dev).manual_seed(l)
    q, k, v = (torch.randn(b, l, nh * 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out = packed_attention(q, k, v, nh, 0.125, out=torch.full_like(q, float("nan")))
    ref = packed_attention_reference(q, k, v, nh, 0.125).float()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()


@pytest.mark.parametrize(
    "b,l,nh", [(1, 1, 1), (3, 65, 12), (2, 127, 1), (3, 128, 2), (1, 129, 12), (5, 200, 3), (2, 192, 2),
               (1, 193, 6), (2, 255, 16), (1, 256, 6), (2, 257, 2), (1, 129, 16)]
)
def test_attention_backward_edge_shapes(dev, b, l, nh):
    g = torch.Generator(device=dev).manual_seed(100 + l)
    q, k, v, do = (torch.randn(b, l, nh * 64, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = packed_attention_fwd_lse(
        q, k, v, nh, 0.125,
        out=(torch.full_like(q, float("nan")), torch.full((b, nh, l), float("nan"), device=dev)))
    o_ref, lse_ref = packed_attention_fwd_lse_reference(q, k, v, nh, 0.125)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2.0 ** -6 * o_ref.float().abs().max().item()
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    grads = packed_attention_bwd(q, k, v, o, do, lse, nh, 0.125,
                                 out=tuple(torch.full_like(q, float("nan")) for _ in range(3)))
    _assert_grads_close(grads, packed_attention_bwd_reference(q, k, v, o, do, lse, nh, 0.125))


# head dim 128 (the forward-LSE and the backward's second instantiation):
# L on both sides of the 64- and 128-row tiles, and the key bound
@pytest.mark.parametrize("b,l,nh,kv", [(1, 1, 2, None), (2, 63, 2, None), (2, 65, 4, None), (3, 129, 6, None),
                                       (2, 192, 2, None), (1, 257, 6, None), (2, 1370, 6, None), (2, 730, 6, 727),
                                       (2, 343, 6, 1), (2, 343, 2, 200), (1, 2917, 6, 2917)])
def test_attention_kernels_at_head_dim_128(dev, b, l, nh, kv):
    """K2 and K3/K4 at 128 against their plain versions, bf16 and f32
    outputs pre-filled with NaN: keys past the bound add nothing and their
    dK/dV rows come out as exact zeros; two backwards equal bit for bit."""
    g = torch.Generator(device=dev).manual_seed(300 + l)
    q, k, v, do = (torch.randn(b, l, nh * 128, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    scale = 128 ** -0.5
    kv_len = l if kv is None else kv
    o_ref, lse_ref = packed_attention_fwd_lse_reference(q, k, v, nh, scale, kv_len=kv_len)
    refs = packed_attention_bwd_reference(q, k, v, o_ref, do, lse_ref, nh, scale, kv_len=kv_len)
    # at kv_len 1 dq and dk are zero in exact arithmetic: the floor grows as sqrt(L)
    atol = 1e-5 * max(1.0, l / 64) ** 0.5
    for dtype in (torch.bfloat16, torch.float32):
        o, lse = packed_attention_fwd_lse(q, k, v, nh, scale, kv_len=kv_len, out_dtype=dtype,
                                          out=(torch.full(q.shape, float("nan"), device=dev, dtype=dtype),
                                               torch.full((b, nh, l), float("nan"), device=dev)))
        assert o.dtype == dtype and torch.isfinite(o).all() and torch.isfinite(lse).all()
        assert (o.float() - o_ref.float()).abs().max().item() <= 2.0 ** -6 * o_ref.float().abs().max().item()
        assert (lse - lse_ref).abs().max().item() <= 1e-3
        runs = [packed_attention_bwd(q, k, v, o_ref, do, lse_ref, nh, scale, kv_len=kv_len, out_dtype=dtype,
                                     out=tuple(torch.full(q.shape, float("nan"), device=dev, dtype=dtype)
                                               for _ in range(3))) for _ in range(2)]
        assert all(torch.equal(x, y) for x, y in zip(*runs))
        assert not runs[0][1][:, kv_len:].any() and not runs[0][2][:, kv_len:].any()
        _assert_grads_close(runs[0], refs, atol)


def _assert_grads_close(grads, refs, atol=1e-5):
    for got, ref in zip(grads, refs):
        got, ref = got.float(), ref.float()
        assert torch.isfinite(got).all()
        # 1e-5 absolute: dq and dk are zero in exact arithmetic at L = 1
        assert (got - ref).abs().max().item() <= 2.0 ** -5 * ref.abs().max().item() + atol
        assert (got - ref).norm().item() <= 2e-2 * ref.norm().item() + atol * ref.numel() ** 0.5


def test_attention_kernels_take_16_byte_aligned_bases(dev):
    """Tensor maps need 16-byte aligned bases, not 128: every input and
    output 16 bytes past a 128-byte boundary."""
    b, l, nh = 2, 193, 6
    g = torch.Generator(device=dev).manual_seed(5)

    def shifted(fill=None):
        buf = torch.empty(b * l * nh * 64 + 64, device=dev, dtype=torch.bfloat16)
        x = buf[8:8 + b * l * nh * 64].view(b, l, nh * 64)
        assert x.data_ptr() % 16 == 0 and x.data_ptr() % 128 != 0
        return x.copy_(torch.randn(b, l, nh * 64, generator=g, device=dev)) if fill is None else x.fill_(fill)

    q, k, v, do = (shifted() for _ in range(4))
    o = packed_attention(q, k, v, nh, 0.125, out=shifted(float("nan")))
    ref = packed_attention_reference(q, k, v, nh, 0.125).float()
    assert (o.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()
    o, lse = packed_attention_fwd_lse(q, k, v, nh, 0.125, out=(shifted(float("nan")), torch.empty(b, nh, l, device=dev)))
    grads = packed_attention_bwd(q, k, v, o, do, lse, nh, 0.125, out=tuple(shifted(float("nan")) for _ in range(3)))
    _assert_grads_close(grads, packed_attention_bwd_reference(q, k, v, o, do, lse, nh, 0.125))


def test_attention_backward_repeats(dev):
    """dQ is summed by reduce-adds in a fixed order, dK and dV in registers:
    two runs on the same inputs agree bit for bit."""
    b, l, nh = 4, 1370, 12
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn(b, l, nh * 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    o, lse = packed_attention_fwd_lse(q, k, v, nh, 0.125)
    first = packed_attention_bwd(q, k, v, o, do, lse, nh, 0.125)
    second = packed_attention_bwd(q, k, v, o, do, lse, nh, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


# the LoRA step's shape (bs16 518px) and the 756px one, where a head's 23
# key tiles walk 46 q tiles; 12 heads of 64 and 6 of 128 (the head-dim-128
# kernel) on the same width
@pytest.mark.parametrize("b,l,hd", [pytest.param(16, 1370, 64, id="16-1370"), pytest.param(4, 2917, 64, id="4-2917"),
                                    pytest.param(16, 1370, 128, id="16-1370-hd128"),
                                    pytest.param(4, 2917, 128, id="4-2917-hd128")])
def test_attention_backward_is_deterministic(dev, b, l, hd):
    """Two backward calls on the same inputs give dq, dk and dv equal bit for
    bit, also when the second call's scratch is memory the first one used
    (its semaphores left at their final counts) and other work runs on the
    card between them; both within the backward's bound of the plain
    version."""
    nh, scale = 768 // hd, hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(b * l)
    q, k, v, do = (torch.randn(b, l, 768, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    o, lse = packed_attention_fwd_lse(q, k, v, nh, scale)
    runs = []
    for _ in range(3):
        runs.append(packed_attention_bwd(q, k, v, o, do, lse, nh, scale,
                                         out=tuple(torch.full_like(q, float("nan")) for _ in range(3))))
        packed_attention(q, k, v, nh, scale)
    torch.cuda.synchronize()
    for again in runs[1:]:
        for name, x, y in zip(("dq", "dk", "dv"), runs[0], again):
            assert torch.equal(x, y), f"{name} differs between runs by up to {(x.float() - y.float()).abs().max()}"
    _assert_grads_close(runs[0], packed_attention_bwd_reference(q, k, v, o, do, lse, nh, scale))


# the ring's chunk lengths: 2917 (756px) over 4 chunks of 730 and 1370 (518px)
# over 4 of 343, and an unsharded 2917; the key bound on both sides of the
# 64- and 128-key tiles, near L and at L
@pytest.mark.parametrize("l", [730, 343, 2917])
@pytest.mark.parametrize("kv", [1, 63, 64, 65, -3, 0])
def test_attention_kernels_with_a_key_bound(dev, l, kv):
    """K2 and K3/K4 with ``kv_len`` (kv <= 0: L + kv) against their plain
    versions, bf16 and f32 outputs pre-filled with NaN: keys past the bound
    add nothing, and their dK/dV rows come out as exact zeros."""
    kv_len = l + kv if kv <= 0 else kv
    b, nh = 2, 12
    g = torch.Generator(device=dev).manual_seed(l + kv_len)
    q, k, v, do = (torch.randn(b, l, nh * 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    o_ref, lse_ref = packed_attention_fwd_lse_reference(q, k, v, nh, 0.125, kv_len=kv_len)
    for dtype in (torch.bfloat16, torch.float32):
        nan = torch.full(q.shape, float("nan"), device=dev, dtype=dtype)
        o, lse = packed_attention_fwd_lse(q, k, v, nh, 0.125, kv_len=kv_len, out_dtype=dtype,
                                          out=(nan, torch.full((b, nh, l), float("nan"), device=dev)))
        assert o.dtype == dtype and torch.isfinite(o).all() and torch.isfinite(lse).all()
        assert (o.float() - o_ref.float()).abs().max().item() <= 2.0 ** -6 * o_ref.float().abs().max().item()
        assert (lse - lse_ref).abs().max().item() <= 1e-3
        if dtype == torch.float32:
            o_bf = packed_attention_fwd_lse(q, k, v, nh, 0.125, kv_len=kv_len)[0]
            assert torch.equal(o.to(torch.bfloat16), o_bf)  # the kernel rounds the same f32 values
    o = o_ref
    refs = packed_attention_bwd_reference(q, k, v, o, do, lse_ref, nh, 0.125, kv_len=kv_len)
    # at kv_len 1 dq and dk are zero in exact arithmetic (a constant softmax):
    # both sides hold the f32 roundoff of dP - D, and dk sums it over the L
    # query rows, so the absolute floor grows as sqrt(L) (1e-5 at L = 64)
    atol = 1e-5 * max(1.0, l / 64) ** 0.5
    for dtype in (torch.bfloat16, torch.float32):
        grads = packed_attention_bwd(q, k, v, o, do, lse_ref, nh, 0.125, kv_len=kv_len, out_dtype=dtype,
                                     out=tuple(torch.full(q.shape, float("nan"), device=dev, dtype=dtype)
                                               for _ in range(3)))
        assert all(x.dtype == dtype for x in grads)
        assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()
        _assert_grads_close(grads, refs, atol)
    with pytest.raises(ValueError, match="kv_len"):
        packed_attention_fwd_lse(q, k, v, nh, 0.125, kv_len=0)
    with pytest.raises(ValueError, match="kv_len"):
        packed_attention_bwd(q, k, v, o, do, lse_ref, nh, 0.125, kv_len=l + 1)


@pytest.mark.parametrize("seq_len", [2917, 1370, 5])
def test_ring_attention_on_the_card(dev, seq_len):
    """The ring over 4 chunks on one card (bf16, 12 heads of 64) against its
    plain version: outputs within K1's bound, gradients within the
    backward's; one forward-LSE launch per query chunk and chunk with a real
    key, as many backward launches; two runs equal bit for bit."""
    from ucod_dpl_tpu_torch.parallel import build_mesh
    from ucod_dpl_tpu_torch.parallel import sp as SP

    mesh = build_mesh({"seq": 4}, devices=[dev] * 4)
    b, nh = 2, 12
    lens = SP.chunk_kv_lens(seq_len, 4)
    g = torch.Generator(device=dev).manual_seed(seq_len)
    full = [torch.randn(b, SP.padded_len(seq_len, 4), nh * 64, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(4)]

    def run(plain):
        leaves = [x.clone().requires_grad_(True) for x in full[:3]]
        chunks = [list(x.chunk(4, dim=1)) for x in leaves]
        out = torch.cat(SP.ring_attention(*chunks, nh, scale=0.125, kv_lens=lens, mesh=mesh, plain=plain), dim=1)
        out.backward(full[3])
        return out.detach(), [x.grad for x in leaves]

    ref = run(plain=True)
    before = (packed_attention_fwd_lse.launches, packed_attention_bwd.launches)
    first = run(plain=False)
    n_pairs = 4 * sum(1 for n in lens if n)
    assert (packed_attention_fwd_lse.launches - before[0], packed_attention_bwd.launches - before[1]) == (
        n_pairs, n_pairs)
    second = run(plain=False)
    assert torch.equal(first[0], second[0]) and all(torch.equal(x, y) for x, y in zip(first[1], second[1]))
    out, r = first[0].float()[:, :seq_len], ref[0].float()[:, :seq_len]
    assert torch.isfinite(out).all() and (out - r).abs().max().item() <= 2.0 ** -6 * r.abs().max().item()
    _assert_grads_close(first[1], ref[1])
    for grad in first[1][1:]:
        assert not grad[:, seq_len:].any()


def test_attention_diff_counts_both_kernels_and_returns_input_dtype(dev):
    q, k, v = (torch.randn(2, 70, 256, device=dev, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    before = (packed_attention_fwd_lse.launches, packed_attention_bwd.launches)
    packed_attention_diff(q, k, v, 4, 0.125).float().square().sum().backward()
    assert (packed_attention_fwd_lse.launches, packed_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    for x in (q, k, v):
        assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError):  # lse of the wrong shape
        packed_attention_bwd(q.detach(), k.detach(), v.detach(), q.detach(), q.detach(),
                             torch.zeros(2, 4, 69, device=dev), 4, 0.125)


@pytest.mark.parametrize("d", [256, 512, 768, 1024])
@pytest.mark.parametrize("rows", [1, 127, 128, 129, 16 * 1370])
def test_layernorm_qkv_kernel_edge_shapes(dev, rows, d):
    """K6 at row counts on both sides of its 128-row tile and at bs16 L1370,
    every hidden size it takes; NaN past the input and in the outputs."""
    g = torch.Generator(device=dev).manual_seed(d + rows)
    x = _nan_tailed(g, dev, (1, rows, d))
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=g, device=dev),
            "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
    lins = [{"w": torch.randn(d, d, generator=g, device=dev) / d ** 0.5,
             "b": 0.1 * torch.randn(d, generator=g, device=dev)} for _ in range(3)]
    outs = layernorm_qkv(x, norm, *lins, 1e-6, out=tuple(torch.full_like(x, float("nan")) for _ in range(3)))
    for o, r in zip(outs, layernorm_qkv_reference(x, norm, *lins, 1e-6)):
        assert torch.isfinite(o).all()
        assert (o.float() - r.float()).abs().max().item() <= 0.02 * r.float().abs().max().item()


# DINOv1 (ViT-B/8): LayerNorm eps 1e-12, a constant row (variance 0: eps
# alone keeps rstd finite) and a row of standard deviation 1e-2
def _dinov1_rows(g, dev, rows, d):
    x = torch.randn(1, rows, d, generator=g, device=dev)
    x[0, 3] = 0.75
    x[0, 5] = 0.5 + 1e-2 * torch.randn(d, generator=g, device=dev)
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("rows", [129, 16 * 1370])
def test_layernorm_qkv_kernel_at_dinov1_eps(dev, rows):
    """K6 at eps 1e-12 (ViT-B/8's LayerNorm) against its plain version, the
    constant row giving LN's bias through each projection."""
    d = 768
    g = torch.Generator(device=dev).manual_seed(rows)
    x = _dinov1_rows(g, dev, rows, d)
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=g, device=dev),
            "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
    lins = [{"w": (torch.randn(d, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16),
             "b": 0.1 * torch.randn(d, generator=g, device=dev)} for _ in range(3)]
    outs = layernorm_qkv(x, norm, *lins, 1e-12, out=tuple(torch.full_like(x, float("nan")) for _ in range(3)))
    for o, r in zip(outs, layernorm_qkv_reference(x, norm, *lins, 1e-12)):
        assert torch.isfinite(o).all()
        assert (o.float() - r.float()).abs().max().item() <= 0.02 * r.float().abs().max().item()


@pytest.mark.parametrize("rows", [129, 16 * 1370])
def test_int8_layernorm_kernels_at_dinov1_eps(dev, rows):
    """K8 and K9 through their wrappers at eps 1e-12, a constant row
    included, against their plain versions (phase D's bounds)."""
    d, f = 768, 3072
    g = torch.Generator(device=dev).manual_seed(7 * rows)
    x = _dinov1_rows(g, dev, rows, d)
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=g, device=dev),
            "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
    q8 = [_q8(g, dev, d, d) for _ in range(3)]
    h_s = quantize_act(FL._layernorm_f32(x, norm, 1e-12))[1]
    outs = FL.layernorm_qkv_w8a8(x, norm, *q8, 1e-12, out=tuple(torch.full_like(x, float("nan")) for _ in range(3)))
    for o, r, qp in zip(outs, FL.layernorm_qkv_w8a8_reference(x, norm, *q8, 1e-12), q8):
        _assert_int8_close(o, r, h_s, qp["w_s"])
    fc1 = _q8(g, dev, d, f)
    codes = torch.full((1, rows, f), -128, dtype=torch.int8, device=dev)
    scales = torch.full((1, rows, 1), float("nan"), device=dev)
    FL.layernorm_fc1_gelu_w8a8(x, norm, fc1, 1e-12, out=(codes, scales))
    _assert_codes_close(codes, scales, *FL.layernorm_fc1_gelu_w8a8_reference(x, norm, fc1, 1e-12))


@pytest.mark.parametrize("b", [1, 16])
def test_attention_kernel_at_the_pseudo_label_length_of_dinov1(dev, b):
    """K1 at L 785 (ViT-B/8 at 224px: 28 x 28 patches and CLS), 12 heads of
    64, into a NaN-filled output, against its plain version."""
    g = torch.Generator(device=dev).manual_seed(785 + b)
    q, k, v = (torch.randn(b, 785, 768, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out = packed_attention(q, k, v, 12, 0.125, out=torch.full_like(q, float("nan")))
    ref = packed_attention_reference(q, k, v, 12, 0.125).float()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()


def test_kernels_count_launches_and_reject_what_they_do_not_take(dev):
    q = torch.randn(1, 70, 256, device=dev, dtype=torch.bfloat16)
    before = packed_attention.launches
    packed_attention(q, q, q, 4, 0.125)
    assert packed_attention.launches == before + 1
    with pytest.raises(TypeError):
        packed_attention(q.float(), q.float(), q.float(), 4, 0.125)
    with pytest.raises(ValueError):
        packed_attention(q, q, q, 32, 0.125)  # head_dim 8
    with pytest.raises(ValueError):
        packed_attention(q, q, q, 3, 0.125)  # 256 columns over 3 heads
    with pytest.raises(ValueError):
        packed_attention(q[..., :128], q[..., :128], q[..., :128], 2, 0.125)  # not contiguous
    norm = {"scale": torch.ones(256, device=dev), "bias": torch.zeros(256, device=dev)}
    lin = {"w": torch.randn(256, 256, device=dev), "b": torch.zeros(256, device=dev)}
    before = layernorm_qkv.launches
    layernorm_qkv(q, norm, lin, lin, lin, 1e-6)
    assert layernorm_qkv.launches == before + 1
    with pytest.raises(TypeError):
        layernorm_qkv(q.float(), norm, lin, lin, lin, 1e-6)
    with pytest.raises(ValueError):  # hidden 128: 256 does not divide it
        narrow = {"w": torch.randn(128, 128, device=dev), "b": torch.zeros(128, device=dev)}
        layernorm_qkv(q[..., :128].contiguous(), {k: v[:128] for k, v in norm.items()},
                      narrow, narrow, narrow, 1e-6)


def _q8(g, dev, d_in, d_out):
    return quantize_linear({"w": torch.randn(d_out, d_in, generator=g, device=dev) / d_in ** 0.5,
                            "b": 0.1 * torch.randn(d_out, generator=g, device=dev)})


def _int8_case(dev, rows, d, seed):
    """bf16 (1, rows, d) followed in memory by NaN rows; rows over six
    decades of scale, row 0 all zero and row 1 constant (when there are
    rows enough)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.full(((rows + 64) * d,), float("nan"), dtype=torch.bfloat16, device=dev)
    x = buf[: rows * d].view(1, rows, d)
    x.copy_(torch.randn(1, rows, d, generator=g, device=dev) * torch.logspace(-3, 3, rows, device=dev)[:, None])
    if rows >= 2:
        x[0, 0], x[0, 1] = 0.0, 0.5
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=g, device=dev),
            "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
    return g, x, norm


def _assert_int8_close(got, ref, s_x, w_s):
    """Row by row: one code step (s_x * 127 * max w_s) plus one bf16 ulp of
    the row's max|plain|."""
    ref = ref.float()
    rowmax = ref.abs().amax(dim=-1, keepdim=True)
    ulp = torch.where(rowmax > 0, torch.exp2(torch.floor(torch.log2(rowmax)) - 7), torch.zeros_like(rowmax))
    assert torch.isfinite(got).all()
    assert ((got.float() - ref).abs() <= s_x * 127 * w_s.max() + ulp).all()


def _assert_codes_close(codes, scales, ref_codes, ref_scales):
    assert torch.isfinite(scales).all()
    diff = (codes.int() - ref_codes.int()).abs()
    assert diff.max().item() <= 1 and (diff == 0).float().mean().item() >= 0.99
    assert ((scales - ref_scales).abs() <= 1e-5 * ref_scales.abs()).all()


@pytest.mark.parametrize("rows,d", [(1, 768), (2, 256), (17, 768), (63, 768), (64, 512), (65, 512), (127, 256),
                                    (128, 768), (129, 1024), (130, 768), (1373, 768)])
def test_int8_row_kernels_edge_shapes(dev, rows, d):
    """K8 and K10: rows on both sides of the 64-row consumer and 128-row work
    tiles, zero, constant and extreme rows, every hidden size they take."""
    g, x, norm = _int8_case(dev, rows, d, rows + d)
    q8 = [_q8(g, dev, d, d) for _ in range(4)]
    h_s = quantize_act(FL._layernorm_f32(x, norm, 1e-6))[1]
    outs = FL.layernorm_qkv_w8a8(x, norm, *q8[:3], 1e-6, out=tuple(torch.full_like(x, float("nan")) for _ in range(3)))
    for o, r, qp in zip(outs, FL.layernorm_qkv_w8a8_reference(x, norm, *q8[:3], 1e-6), q8):
        _assert_int8_close(o, r, h_s, qp["w_s"])
    got = FL.dense_quant_w8a8(x, q8[3], torch.bfloat16, out=torch.full_like(x, float("nan")))
    _assert_int8_close(got, FL.dense_quant_w8a8_reference(x, q8[3], torch.bfloat16), quantize_act(x)[1],
                       q8[3]["w_s"])


@pytest.mark.parametrize("rows,d,f", [(1, 768, 3072), (15, 256, 1024), (17, 768, 3072), (63, 768, 3072),
                                      (64, 256, 1024), (65, 512, 1536), (100, 512, 1536), (127, 768, 1536),
                                      (128, 1024, 2048), (129, 768, 1024), (1373, 768, 3072)])
def test_int8_mlp_kernels_edge_shapes(dev, rows, d, f):
    """K9 and K11: rows on both sides of their 64-row cluster tile, zero,
    constant and extreme rows, every expansion they are built for (1024,
    1536, 2048, 3072) and every hidden size; K11 gives the bits of the split
    kernel path (the same codes, exact s32 sums, the same rescale)."""
    g, x, norm = _int8_case(dev, rows, d, 7 * rows + f)
    fc1, fc2 = _q8(g, dev, d, f), _q8(g, dev, f, d)
    codes = torch.full((1, rows, f), -128, dtype=torch.int8, device=dev)
    scales = torch.full((1, rows, 1), float("nan"), device=dev)
    FL.layernorm_fc1_gelu_w8a8(x, norm, fc1, 1e-6, out=(codes, scales))
    ref_codes, ref_scales = FL.layernorm_fc1_gelu_w8a8_reference(x, norm, fc1, 1e-6)
    _assert_codes_close(codes, scales, ref_codes, ref_scales)
    got = FL.layernorm_mlp_w8a8(x, norm, fc1, fc2, 1e-6, out=torch.full_like(x, float("nan")))
    _assert_int8_close(got, FL.layernorm_mlp_w8a8_reference(x, norm, fc1, fc2, 1e-6), ref_scales, fc2["w_s"])
    assert torch.equal(got, dense_w8a8_pre(codes, scales, fc2, torch.bfloat16))


def test_int8_kernels_count_launches_and_reject_what_they_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 70, 256, device=dev, dtype=torch.bfloat16)
    norm = {"scale": torch.ones(256, device=dev), "bias": torch.zeros(256, device=dev)}
    lin, fc1, fc2 = _q8(g, dev, 256, 256), _q8(g, dev, 256, 1024), _q8(g, dev, 1024, 256)
    calls = ((FL.layernorm_qkv_w8a8, (norm, lin, lin, lin, 1e-6)), (FL.dense_quant_w8a8, (lin, torch.bfloat16)),
             (FL.layernorm_fc1_gelu_w8a8, (norm, fc1, 1e-6)), (FL.layernorm_mlp_w8a8, (norm, fc1, fc2, 1e-6)))
    for fn, args in calls:
        before = fn.launches
        fn(x, *args)
        assert fn.launches == before + 1
        with pytest.raises(TypeError):  # f32 activations
            fn(x.float(), *args)
        with pytest.raises(ValueError):  # not contiguous
            fn(x.transpose(0, 1), *args)
    with pytest.raises(ValueError):  # hidden 128: 8 values a lane, 32 lanes
        FL.dense_quant_w8a8(x[..., :128].contiguous(), _q8(g, dev, 128, 256), torch.bfloat16)
    with pytest.raises(ValueError):  # 384 output columns: not whole 256-column tiles
        FL.dense_quant_w8a8(x, _q8(g, dev, 256, 384), torch.bfloat16)
    before = FL.layernorm_fc1_gelu_w8a8.launches
    for f in (4096, 1280, 512):  # K9's 16 column parts of 256, 80, 32: no wgmma width it is built for
        with pytest.raises(ValueError):
            FL.layernorm_fc1_gelu_w8a8(x, norm, _q8(g, dev, 256, f), 1e-6)
    assert FL.layernorm_fc1_gelu_w8a8.launches == before
    with pytest.raises(ValueError):  # K11 takes K9's expansions: 16 column parts of 256, no width it is built for
        FL.layernorm_mlp_w8a8(x, norm, _q8(g, dev, 256, 4096), _q8(g, dev, 4096, 256), 1e-6)


def test_int8_kernels_write_no_row_past_the_last(dev):
    """K8, K9, K10 and K11 at 65 rows (one row into the second 64-row tile)
    and 1 row: the input is followed by NaN rows, the outputs are views of
    larger buffers whose rows past the last are pre-filled (NaN, codes -128,
    which no code takes) and stay so; the pre-pass's scratch is sized to the
    rows."""
    d, f = 768, 3072
    for rows in (65, 1):
        g, x, norm = _int8_case(dev, rows, d, 31 + rows)
        q8 = [_q8(g, dev, d, d) for _ in range(4)]
        fc1, fc2 = _q8(g, dev, d, f), _q8(g, dev, f, d)
        bufs = [torch.full((rows + 64, d), float("nan"), dtype=torch.bfloat16, device=dev) for _ in range(5)]
        outs = FL.layernorm_qkv_w8a8(x, norm, *q8[:3], 1e-6, out=tuple(b[:rows].view(1, rows, d) for b in bufs[:3]))
        h_s = quantize_act(FL._layernorm_f32(x, norm, 1e-6))[1]
        for o, r, qp in zip(outs, FL.layernorm_qkv_w8a8_reference(x, norm, *q8[:3], 1e-6), q8):
            _assert_int8_close(o, r, h_s, qp["w_s"])
        got = FL.dense_quant_w8a8(x, q8[3], torch.bfloat16, out=bufs[3][:rows].view(1, rows, d))
        _assert_int8_close(got, FL.dense_quant_w8a8_reference(x, q8[3], torch.bfloat16), quantize_act(x)[1],
                           q8[3]["w_s"])
        codes_buf = torch.full((rows + 64, f), -128, dtype=torch.int8, device=dev)
        scales_buf = torch.full((rows + 64,), float("nan"), device=dev)
        codes, scales = FL.layernorm_fc1_gelu_w8a8(
            x, norm, fc1, 1e-6, out=(codes_buf[:rows].view(1, rows, f), scales_buf[:rows].view(1, rows, 1)))
        _assert_codes_close(codes, scales, *FL.layernorm_fc1_gelu_w8a8_reference(x, norm, fc1, 1e-6))
        got = FL.layernorm_mlp_w8a8(x, norm, fc1, fc2, 1e-6, out=bufs[4][:rows].view(1, rows, d))
        assert torch.equal(got, dense_w8a8_pre(codes, scales, fc2, torch.bfloat16))
        torch.cuda.synchronize()
        for b in bufs:
            assert torch.isnan(b[rows:].float()).all()
        assert (codes_buf[rows:] == -128).all() and torch.isnan(scales_buf[rows:]).all()


def test_int8_kernels_repeat_bit_for_bit(dev):
    """K8, K9, K11 and K7 twice on the same inputs: equal outputs (exact s32
    sums, whose order cannot show, no float atomics, the row maxima gathered
    in a fixed order)."""
    rows, d, f = 4 * 1370 + 3, 768, 3072
    g, x, norm = _int8_case(dev, rows, d, 77)
    q8 = [_q8(g, dev, d, d) for _ in range(3)]
    fc1, fc2 = _q8(g, dev, d, f), _q8(g, dev, f, d)
    first = FL.layernorm_qkv_w8a8(x, norm, *q8, 1e-6)
    second = FL.layernorm_qkv_w8a8(x, norm, *q8, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    first = FL.layernorm_fc1_gelu_w8a8(x, norm, fc1, 1e-6)
    second = FL.layernorm_fc1_gelu_w8a8(x, norm, fc1, 1e-6)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(FL.layernorm_mlp_w8a8(x, norm, fc1, fc2, 1e-6), FL.layernorm_mlp_w8a8(x, norm, fc1, fc2, 1e-6))
    bf16_fc1 = {"w": (torch.randn(f, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16),
                "b": 0.1 * torch.randn(f, generator=g, device=dev)}
    xs = torch.randn(1, rows, d, generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(FL.layernorm_fc1_gelu(xs, norm, bf16_fc1, 1e-6), FL.layernorm_fc1_gelu(xs, norm, bf16_fc1, 1e-6))


def _nan_tailed(g, dev, shape, scale=1.0):
    """A contiguous bf16 normal tensor of ``shape`` whose memory is followed by
    NaN: a kernel that reads past its last row reads NaN."""
    n = 1
    for s_ in shape:
        n *= s_
    buf = torch.full((n + 64 * shape[-1],), float("nan"), dtype=torch.bfloat16, device=dev)
    x = buf[:n].view(shape)
    x.copy_(torch.randn(shape, generator=g, device=dev) * scale)
    return x


# K12 at D 768 (12 heads), 512 and 256, L on both sides of the 64-row query
# block and the 128-key tile, 1 and the serving length
@pytest.mark.parametrize("b,l,nh", [(1, 1370, 12), (1, 65, 12), (2, 1, 12), (3, 129, 12), (2, 200, 4),
                                    (1, 257, 8), (2, 64, 4), (1, 128, 12)])
def test_attention_outproj_kernel_edge_shapes(dev, b, l, nh):
    """K12 on the part it computes, out - x: within 2^-6 of max|plain - x|
    plus one bf16 ulp of the output per element (chip_smoke.py's K12 bound),
    NaN past the inputs and in the output buffer."""
    g = torch.Generator(device=dev).manual_seed(7 * l + nh)
    d = 64 * nh
    q, k, v, x = (_nan_tailed(g, dev, (b, l, d)) for _ in range(4))
    wo = (torch.randn(d, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16)
    bo, ls = 0.1 * torch.randn(d, generator=g, device=dev), 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    out = attention_outproj_residual(q, k, v, x, wo, bo, ls, nh, 0.125, out=torch.full_like(q, float("nan")))
    ref = attention_outproj_residual_reference(q, k, v, x, wo, bo, ls, nh, 0.125).float()
    assert torch.isfinite(out).all()
    out = out.float()
    exponent = torch.frexp(torch.maximum(out.abs(), ref.abs()).clamp_min(2.0 ** -126)).exponent
    ulp = torch.ldexp(torch.ones_like(ref), exponent - 8)
    assert ((out - ref).abs() <= 2.0 ** -6 * (ref - x.float()).abs().max().item() + ulp).all()


# K13 at 224px (pseudo-labels), 756px (CORAL's m-patches), the serving size
# without position rows, non-square images, D 512
@pytest.mark.parametrize("b,h,w,d,with_pos", [(1, 224, 224, 768, True), (2, 756, 756, 768, True),
                                              (1, 518, 518, 768, False), (3, 14, 28, 768, True),
                                              (1, 42, 518, 768, False), (2, 56, 70, 512, True)])
def test_patch_embed_kernel_edge_shapes(dev, b, h, w, d, with_pos):
    """K13 within one bf16 ulp of max|plain| (2^-7 of it: chip_smoke.py's
    K13_TOL), NaN past the pixels; its output is a view of a larger buffer
    whose rows past the last stay NaN."""
    g = torch.Generator(device=dev).manual_seed(h + w + d)
    buf = torch.full((b * h * w * 3 + 1024,), float("nan"), device=dev)
    px = buf[:b * h * w * 3].view(b, h, w, 3)
    px.copy_(torch.randn(b, h, w, 3, generator=g, device=dev))
    n = h // 14 * (w // 14)
    weight = (0.02 * torch.randn(588, d, generator=g, device=dev)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(d, generator=g, device=dev)
    pos = (0.1 * torch.randn(n, d, generator=g, device=dev)).to(torch.bfloat16) if with_pos else None
    obuf = torch.full((b * n + 128, d), float("nan"), dtype=torch.bfloat16, device=dev)
    out = patch_embed(px, weight, bias, pos, out=obuf[:b * n].view(b, n, d))
    ref = patch_embed_reference(px, weight, bias, pos).float()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()
    assert torch.isnan(obuf[b * n:].float()).all()


def test_prototype_kernels_count_launches_and_reject_what_they_do_not_take(dev):
    q, k, v, x = (torch.randn(2, 70, 768, device=dev, dtype=torch.bfloat16) for _ in range(4))
    wo = torch.randn(768, 768, device=dev).to(torch.bfloat16)
    bo, ls = torch.zeros(768, device=dev), torch.ones(768, device=dev)
    px = torch.randn(2, 56, 56, 3, device=dev)
    weight, bias = torch.randn(588, 768, device=dev).to(torch.bfloat16), torch.zeros(768, device=dev)
    before = (attention_outproj_residual.launches, patch_embed.launches)
    attention_outproj_residual(q, k, v, x, wo, bo, ls, 12, 0.125)
    patch_embed(px, weight, bias)
    assert (attention_outproj_residual.launches, patch_embed.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):  # f32 activations
        attention_outproj_residual(q.float(), k, v, x, wo, bo, ls, 12, 0.125)
    with pytest.raises(ValueError):  # f32 out-projection
        attention_outproj_residual(q, k, v, x, wo.float(), bo, ls, 12, 0.125)
    with pytest.raises(ValueError):  # bf16 bias
        attention_outproj_residual(q, k, v, x, wo, bo.to(torch.bfloat16), ls, 12, 0.125)
    with pytest.raises(ValueError):  # head dim 128
        attention_outproj_residual(q, k, v, x, wo, bo, ls, 6, 0.125)
    with pytest.raises(ValueError):  # 20 heads: D 1280 > 768
        big = torch.randn(1, 8, 1280, device=dev, dtype=torch.bfloat16)
        attention_outproj_residual(big, big, big, big, torch.randn(1280, 1280, device=dev).to(torch.bfloat16),
                                   torch.zeros(1280, device=dev), torch.ones(1280, device=dev), 20, 0.125)
    with pytest.raises(ValueError):  # bf16 pixels
        patch_embed(px.to(torch.bfloat16), weight, bias)
    with pytest.raises(ValueError):  # 50 px: not a multiple of 14
        patch_embed(px[:, :50].contiguous(), weight, bias)
    with pytest.raises(ValueError):  # f32 weight
        patch_embed(px, weight.float(), bias)
    with pytest.raises(ValueError):  # position rows of another grid
        patch_embed(px, weight, bias, torch.zeros(15, 768, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # D 384: not a multiple of 256
        patch_embed(px, weight[:, :384].contiguous(), bias[:384])
    assert (attention_outproj_residual.launches, patch_embed.launches) == (before[0] + 1, before[1] + 1)


# the prototype variants that compute K1's function, the constant shift, and
# the scale folded into q by the kernel
K1_FUNCTION_VARIANTS = [n for n in AB.PROTO_VARIANTS
                        if AB.plain_of(n) is packed_attention_reference] + ["fwd_shift", "fwd_scale_q"]


@pytest.fixture(scope="module")
def variants_lib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return AB.build_variants(K1_FUNCTION_VARIANTS, subdir="variants_test")


@pytest.mark.parametrize("l", [1, 65, 257, 1370])
@pytest.mark.parametrize("name", K1_FUNCTION_VARIANTS)
def test_attention_prototype_variant_matches_its_plain_function(dev, variants_lib, name, l):
    """Within K1's bound (2^-6 of max|plain|), into a NaN-filled output."""
    g = torch.Generator(device=dev).manual_seed(l)
    q, k, v = (torch.randn(2, l, 768, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    out = AB.variant_fn(variants_lib, name)(q, k, v, out=torch.full_like(q, float("nan")))
    ref = AB.plain_of(name)(q, k, v, 12, AB.SCALE).float()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()


@pytest.mark.parametrize("bh,l,d", [(1, 1, 16), (3, 65, 16), (5, 63, 32), (80, 257, 32), (4, 129, 64),
                                    (48, 1370, 64), (2, 200, 128), (1, 2917, 128)])
def test_heads_attention_kernel_edge_shapes(dev, bh, l, d):
    """K5 at each instantiated head dim, L below, at and past a 64-row tile,
    large logits (q x 3), NaN past the inputs and in the output buffer."""
    g = torch.Generator(device=dev).manual_seed(bh * l + d)
    q, k, v = (_nan_tailed(g, dev, (bh, l, d), s) for s in (3.0, 1.0, 1.0))
    out = heads_attention(q, k, v, d ** -0.5, out=torch.full_like(q, float("nan")))
    ref = heads_attention_reference(q, k, v, d ** -0.5).float()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()


def test_multi_head_attention_routes_odd_heads_to_the_packed_forward_on_the_card(dev):
    """3 heads of 64 (odd: the JAX dispatch splits them to its per-head K5)
    and 2 heads of 64 both launch the packed forward once, no split."""
    q = torch.randn(2, 70, 3 * 64, device=dev, dtype=torch.bfloat16)
    before = (packed_attention.launches, heads_attention.launches)
    got = multi_head_attention(q, q, q, 3, 0.125)
    assert (packed_attention.launches, heads_attention.launches) == (before[0] + 1, before[1])
    ref = packed_attention_reference(q, q, q, 3, 0.125).float()
    assert (got.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()
    multi_head_attention(q[..., :128].contiguous(), q[..., :128].contiguous(), q[..., :128].contiguous(), 2, 0.125)
    assert (packed_attention.launches, heads_attention.launches) == (before[0] + 2, before[1])


@pytest.mark.parametrize("l", [1, 63, 65, 129, 1370])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("nh", [1, 3, 5, 12])
def test_attention_forward_every_head_dim_and_count(dev, nh, d, l):
    """The forward on the packed (B, L, nh * d) layout at every head dim it is
    built for and odd and even head counts, L on both sides of the 64- and
    128-row tiles; large logits (q x 3), NaN past the inputs and in the
    output buffer."""
    g = torch.Generator(device=dev).manual_seed(1000 * nh + 10 * d + l)
    q, k, v = (_nan_tailed(g, dev, (2, l, nh * d), s) for s in (3.0, 1.0, 1.0))
    out = packed_attention(q, k, v, nh, d ** -0.5, out=torch.full_like(q, float("nan")))
    ref = packed_attention_reference(q, k, v, nh, d ** -0.5).float()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -6 * ref.abs().max().item()


def test_differentiable_forward_routes_like_jax_differentiable_mode(dev):
    """3 heads of 64, which the JAX differentiable_mode sends to
    _xla_attention, run the plain version under autograd (no attention kernel
    launches); 2 heads of 128, which it sends to its flash VJP kernels,
    launch the forward-LSE and the backward (once each, one attention
    layer), and K1 alone when autograd records nothing; 2 heads of 192,
    which it sends there too, raise: the port's backward is built for head
    dims 64 and 128, and nothing falls back."""
    from ucod_dpl_tpu_torch.models import dino as TD

    for nh, hd in ((3, 64), (2, 128), (2, 192)):
        px = torch.randn(1, 28, 28, 3, device=dev, requires_grad=True)
        cfg = TD.DinoConfig(variant="dinov2", image_size=28, patch_size=14, hidden_size=nh * hd, num_layers=2,
                            num_heads=nh, mlp_ratio=2)
        params = TD.cast_params(TD.init_dino(0, cfg, device=dev), torch.bfloat16)
        before = (packed_attention.launches, packed_attention_fwd_lse.launches, packed_attention_bwd.launches,
                  heads_attention.launches)
        if hd == 192:
            with pytest.raises(ValueError, match="d in"):
                TD.dino_forward(params, px, cfg, compute_dtype=torch.bfloat16, differentiable=True)
            continue
        out = TD.dino_forward(params, px, cfg, compute_dtype=torch.bfloat16, differentiable=True)
        out["key_features"].float().square().sum().backward()
        assert torch.isfinite(out["key_features"]).all() and torch.isfinite(px.grad).all()
        after = (packed_attention.launches, packed_attention_fwd_lse.launches, packed_attention_bwd.launches,
                 heads_attention.launches)
        assert [a - b for a, b in zip(after, before)] == ([0, 0, 0, 0] if nh == 3 else [0, 1, 1, 0])
        if nh == 2:
            with torch.no_grad():
                TD.dino_forward(params, px, cfg, compute_dtype=torch.bfloat16, differentiable=True)
            assert (packed_attention.launches, packed_attention_fwd_lse.launches) == (after[0] + 1, after[1])


def test_heads_attention_counts_launches_and_rejects_what_it_does_not_take(dev):
    q = torch.randn(6, 70, 64, device=dev, dtype=torch.bfloat16)
    before = heads_attention.launches
    heads_attention(q, q, q, 0.125)
    assert heads_attention.launches == before + 1
    with pytest.raises(TypeError):  # f32
        heads_attention(q.float(), q.float(), q.float(), 0.125)
    with pytest.raises(ValueError):  # head dim 48
        x = q[..., :48].contiguous()
        heads_attention(x, x, x, 0.125)
    with pytest.raises(ValueError):  # not contiguous
        heads_attention(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 0.125)
    assert heads_attention.launches == before + 1


@pytest.mark.parametrize("rows,d,f", [(1, 768, 3072), (17, 768, 3072), (65, 256, 256), (130, 320, 512),
                                      (1373, 768, 3072), (127, 320, 512), (128, 320, 768), (129, 320, 256),
                                      (127, 256, 1024), (128, 256, 512), (129, 768, 3072)])
def test_layernorm_fc1_gelu_kernel_ragged_rows(dev, rows, d, f):
    """K7 at row counts on both sides of its 128-row work tile, other widths
    (320: not a multiple of 256, an odd count of 64-column k-tiles), NaN past
    the input and in the output buffer."""
    g = torch.Generator(device=dev).manual_seed(rows + d + f)
    x = _nan_tailed(g, dev, (1, rows, d))
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=g, device=dev),
            "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
    fc1 = {"w": (torch.randn(f, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16),
           "b": 0.1 * torch.randn(f, generator=g, device=dev)}
    out = FL.layernorm_fc1_gelu(x, norm, fc1, 1e-6,
                                out=torch.full((1, rows, f), float("nan"), dtype=torch.bfloat16, device=dev))
    ref = FL.layernorm_fc1_gelu_reference(x, norm, fc1, 1e-6).float()
    assert torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= 0.02 * ref.abs().max().item()


def test_layernorm_fc1_gelu_counts_launches_and_rejects_what_it_does_not_take(dev):
    x = torch.randn(2, 70, 256, device=dev, dtype=torch.bfloat16)
    norm = {"scale": torch.ones(256, device=dev), "bias": torch.zeros(256, device=dev)}
    fc1 = {"w": torch.randn(512, 256, device=dev), "b": torch.zeros(512, device=dev)}
    before = FL.layernorm_fc1_gelu.launches
    FL.layernorm_fc1_gelu(x, norm, fc1, 1e-6)
    assert FL.layernorm_fc1_gelu.launches == before + 1
    with pytest.raises(TypeError):  # f32 activations
        FL.layernorm_fc1_gelu(x.float(), norm, fc1, 1e-6)
    with pytest.raises(ValueError):  # not contiguous
        FL.layernorm_fc1_gelu(x.transpose(0, 1), norm, fc1, 1e-6)
    with pytest.raises(ValueError):  # an expansion of 384: not a multiple of 256
        FL.layernorm_fc1_gelu(x, norm, {"w": fc1["w"][:384], "b": fc1["b"][:384]}, 1e-6)
    with pytest.raises(ValueError):  # hidden 96: not a multiple of 64
        FL.layernorm_fc1_gelu(x[..., :96].contiguous(), {k: t[:96] for k, t in norm.items()},
                              {"w": fc1["w"][:, :96], "b": fc1["b"]}, 1e-6)
    assert FL.layernorm_fc1_gelu.launches == before + 1


def test_layernorm_fc1_gelu_writes_no_row_past_the_last(dev):
    """K7 at 129 rows (one row into the second 128-row work tile) and 1 row,
    D 320 and 768: its output is a view of a larger buffer whose rows past
    the last are NaN and stay so; the statistics scratch is sized to the
    rows."""
    for rows, d, f in ((129, 320, 512), (1, 768, 3072)):
        g = torch.Generator(device=dev).manual_seed(3 * rows + d)
        x = _nan_tailed(g, dev, (1, rows, d))
        norm = {"scale": 1 + 0.1 * torch.randn(d, generator=g, device=dev),
                "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
        fc1 = {"w": (torch.randn(f, d, generator=g, device=dev) / d ** 0.5).to(torch.bfloat16),
               "b": 0.1 * torch.randn(f, generator=g, device=dev)}
        buf = torch.full((rows + 128, f), float("nan"), dtype=torch.bfloat16, device=dev)
        out = FL.layernorm_fc1_gelu(x, norm, fc1, 1e-6, out=buf[:rows].view(1, rows, f))
        ref = FL.layernorm_fc1_gelu_reference(x, norm, fc1, 1e-6).float()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out.float() - ref).abs().max().item() <= 0.02 * ref.abs().max().item()
        assert torch.isnan(buf[rows:].float()).all()


def test_eval_entry_launches_k1_and_k6_per_forward(dev, tmp_path):
    """``cli.eval_main`` on the card over 3 images at a small width (256 wide,
    4 heads of 64, 3 layers, 56px): the cache build and every LookTwice crop
    batch each launch K1 and K6 twice (every layer but the last), nothing
    else launches, and a second run reads the cache (crop passes only) to
    the same metrics."""
    import numpy as np
    from PIL import Image

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.ops.attention import heads_attention, packed_attention_bwd, packed_attention_fwd_lse
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_fc1_gelu

    rng = np.random.default_rng(0)
    for sub in ("im", "gt"):
        (tmp_path / "RefCOD" / "SYN" / sub).mkdir(parents=True)
    for i, (h, w) in enumerate(((48, 64), (60, 80), (72, 128))):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(tmp_path / "RefCOD" / "SYN" / "im" / f"{i}.jpg")
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4 : h // 2, w // 4 : w // 2] = 255
        Image.fromarray(mask).save(tmp_path / "RefCOD" / "SYN" / "gt" / f"{i}.png")
    arch = {"hidden_size": 256, "num_layers": 3, "num_heads": 4, "patch_size": 14, "image_size": 56}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "tiny.py").write_text(
        f"cfg = dict(_BASE_=[{os.path.join(repo, 'configs', 'uscod', 'UCOD-DPL_dinov2.py')!r}], "
        f"model_cfg=dict(dim=256, feature_size=8), dataset_cfg=dict(feature_extractor_cfg=dict(arch={arch!r})))\n")
    argv = ["-c", str(tmp_path / "tiny.py"), "--work_dir", str(tmp_path / "wd"), "--datasets", "SYN", "--opts",
            "dataset_cfg.dataset_dir", str(tmp_path / "RefCOD"), "dataset_cfg.cache_dir", str(tmp_path / "cache"),
            "dataset_cfg.valset_cfg.image_size", "(56, 56)", "val_cfg.look_twice_th", "0.95"]
    wrappers = (packed_attention, layernorm_qkv, heads_attention, packed_attention_fwd_lse, packed_attention_bwd,
                layernorm_fc1_gelu, FL.layernorm_qkv_w8a8, FL.layernorm_fc1_gelu_w8a8, FL.dense_quant_w8a8,
                FL.layernorm_mlp_w8a8)
    results = []
    for cache_batches in (1, 0):  # the first run builds the cache in one batch of 3, the second reads it
        for fn in wrappers:
            fn.launches = 0
        runner = cli.eval_main(argv)["SYN"]
        forwards = cache_batches + runner.evaluator.crop_batches
        assert packed_attention.launches == layernorm_qkv.launches == 2 * forwards
        assert not any(fn.launches for fn in wrappers[2:])
        result = runner.evaluator.result
        assert all(np.isfinite(v) and 0 <= v <= 1 for v in result.values())
        results.append(result)
    assert results[0] == results[1]


def _train_world(root, rng, train_labels=False):
    """Two train directories of 2 JPEGs (with masks when ``train_labels``), a
    val directory of 2 with masks, and a seeded pseudo-label cache in the JAX
    generator's layout."""
    import hashlib

    import numpy as np
    from PIL import Image

    from ucod_dpl_tpu_torch.utils.fileio import ArrayCache

    for name, labels in (("TR-A", train_labels), ("TR-B", train_labels), ("TE-A", True)):
        (root / "RefCOD" / name / "im").mkdir(parents=True)
        if labels:
            (root / "RefCOD" / name / "gt").mkdir(parents=True)
        for i, (h, w) in enumerate(((48, 64), (72, 128))):
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
                root / "RefCOD" / name / "im" / f"{i}.jpg")
            if labels:
                mask = np.zeros((h, w), np.uint8)
                mask[h // 4 : h // 2, w // 4 : w // 2] = 255
                Image.fromarray(mask).save(root / "RefCOD" / name / "gt" / f"{i}.png")
    paths = sorted(p for ds in ("TR-A", "TR-B") for p in (root / "RefCOD" / ds / "im").iterdir())
    cache = ArrayCache(root / "cache" / "pseudo_label_cache" / "TR-A+TR-B")
    for i in range(len(paths)):
        cache.write(i, np.where(rng.random((16, 16, 1)) > 0.5, 1.0, 0.0).astype(np.float32))
    stems = "\n".join(p.stem for p in paths)
    cache.flush(meta={"n": len(paths), "fingerprint": hashlib.sha1(stems.encode()).hexdigest(), "th_bkg": 0.6})


@pytest.mark.parametrize("lora", [False, True])
def test_train_entry_launches_and_resumes_on_the_card(dev, tmp_path, monkeypatch, lora):
    """``cli.train_main`` on the card at a small width (256 wide, 4 heads of
    64, 3 layers, 56px, batch 2, 2 epochs): K1 and K6 launch twice per
    backbone forward of the cache builds and the crop pass and nowhere else;
    with LoRA each LoRA step launches the forward-LSE and the backward twice
    and each discriminator batch's adapted forward (no autograd) K1 twice;
    the losses are finite; two uninterrupted runs end bit for bit equal, and
    a run preempted by SIGTERM after its 3rd step and resumed from
    ``state_preempt`` ends bit for bit as an uninterrupted run does (cudnn
    deterministic; the backward's dQ is summed in a fixed order)."""
    import signal

    import numpy as np

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.engine import train_loop
    from ucod_dpl_tpu_torch.models.convert import tree_leaves
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_fc1_gelu

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _train_world(tmp_path, np.random.default_rng(0))
    arch = {"hidden_size": 256, "num_layers": 3, "num_heads": 4, "patch_size": 14, "image_size": 56}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "tiny.py").write_text(
        f"cfg = dict(_BASE_=[{os.path.join(repo, 'configs', 'uscod', 'UCOD-DPL_dinov2.py')!r}], "
        f"model_cfg=dict(dim=256, feature_size=8), dataset_cfg=dict(feature_extractor_cfg=dict(arch={arch!r})))\n")

    def argv(run, *flags):
        return ["-c", str(tmp_path / "tiny.py"), "--work_dir", str(tmp_path / "wd"), *flags, "--opts",
                "dataset_cfg.dataset_dir", str(tmp_path / "RefCOD"), "dataset_cfg.cache_dir", str(tmp_path / "cache"),
                "log_cfg.log_path", str(tmp_path / f"logs_{run}"), "dataset_cfg.trainset_cfg.DATASET", "TR-A+TR-B",
                "dataset_cfg.valset_cfg.DATASET", "TE-A", "dataset_cfg.trainset_cfg.image_size", "(56, 56)",
                "dataset_cfg.valset_cfg.image_size", "(56, 56)", "dataset_cfg.trainloader_cfg.batch_size", "2",
                "model_cfg.lora.enable", str(lora), "train_cfg.max_epoch", "2", "train_cfg.start_finetune", "-1",
                "train_cfg.save_cfg.save_mode", "all", "train_cfg.save_cfg.save_interval", "2",
                "train_cfg.save_cfg.start_save", "0", "val_cfg.val_interval", "2", "val_cfg.start_val", "2",
                "val_cfg.look_twice_th", "0.95"]

    steps = {"n": 0, "losses": [], "preempt_at": None}
    name = "make_lora_train_step" if lora else "make_train_step"
    orig_make = getattr(train_loop, name)

    def make(*a, **k):
        inner = orig_make(*a, **k)

        def step(*sa):
            aux = inner(*sa)
            steps["n"] += 1
            steps["losses"].append(float(aux["loss"]))
            if steps["n"] == steps["preempt_at"]:
                os.kill(os.getpid(), signal.SIGTERM)
            return aux

        return step

    monkeypatch.setattr(train_loop, name, make)
    wrappers = (packed_attention, layernorm_qkv, heads_attention, packed_attention_fwd_lse, packed_attention_bwd,
                layernorm_fc1_gelu, FL.layernorm_qkv_w8a8, FL.layernorm_fc1_gelu_w8a8, FL.dense_quant_w8a8,
                FL.layernorm_mlp_w8a8)
    for fn in wrappers:
        fn.launches = 0
    try:
        runner = cli.train_main(argv("a"))
        crops = runner.evaluator.crop_batches  # the one validation, at epoch 2
        forwards = 2 + crops  # the train-set and val-set cache builds (one batch each), the crop calls
        # K1 also in the 2 discriminator batches' adapted forwards, which run under no_grad
        assert packed_attention.launches == 2 * forwards + (2 * 2 if lora else 0)
        assert layernorm_qkv.launches == 2 * forwards
        assert packed_attention_fwd_lse.launches == (2 * 4 if lora else 0)  # 4 LoRA steps
        assert packed_attention_bwd.launches == (2 * 4 if lora else 0)
        assert not any(fn.launches for fn in (heads_attention, *wrappers[5:]))
        assert steps["n"] == 4 and np.isfinite(steps["losses"]).all()

        def params(r):
            trees = [r.decoder_params, r.decoder_ema_params, r.discriminator_params]
            if lora:
                trees.append(r.train_loop.lora_params)
            return torch.cat([t.detach().float().flatten() for tree in trees for t in tree_leaves(tree)])

        ref, again = params(runner), params(cli.train_main(argv("a2")))
        steps["preempt_at"], steps["n"] = 3, 0
        with pytest.raises(SystemExit) as e:
            cli.train_main(argv("b"))
        assert e.value.code == 128 + signal.SIGTERM
        path = str(tmp_path / "logs_b" / "ckp" / "state_preempt")
        steps["preempt_at"] = None
        resumed = cli.train_main(argv("b", "--resume", path))
        assert resumed.train_loop.start_epoch == 1 and steps["n"] == 4  # epoch 1's first step was applied before
        assert torch.equal(again, ref), f"two uninterrupted runs differ by up to {(again - ref).abs().max()}"
        last = params(resumed)
        assert torch.equal(last, ref), f"the resumed run differs by up to {(last - ref).abs().max()}"
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)


def test_lt_train_entry_launches_and_repeats_on_the_card(dev, tmp_path, monkeypatch):
    """``cli.lt_train_main`` on configs/uscod/CORAL_dinov2.py at a small
    width (256 wide, 4 heads of 64, 12 layers, 56px; window length 8, batch
    2, 2 epochs, a validation at epoch 2) with m-patches for the train set (a
    756px forward, L 2917, an image): K1 and K6 launch 11 times per backbone
    forward of the caches (train: features, grid patches, m-patches; val:
    features, grid patches) and of the validation's centre-crop fallbacks,
    nothing else launches; the losses are finite and the refiner moves; a
    second run from the same caches (cuDNN deterministic) writes every
    refiner and EMA file equal bit for bit."""
    import numpy as np
    from safetensors.torch import load_file

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_fc1_gelu

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _train_world(tmp_path, np.random.default_rng(1), train_labels=True)
    arch = {"hidden_size": 256, "num_layers": 12, "num_heads": 4, "patch_size": 14, "image_size": 56}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "tiny.py").write_text(
        f"cfg = dict(_BASE_=[{os.path.join(repo, 'configs', 'uscod', 'CORAL_dinov2.py')!r}], "
        f"model_cfg=dict(dim=256, feature_size=8, window_length=8), "
        f"dataset_cfg=dict(feature_extractor_cfg=dict(arch={arch!r})))\n")

    def argv(run):
        return ["-c", str(tmp_path / "tiny.py"), "--work_dir", str(tmp_path / "wd"), "--opts",
                "dataset_cfg.dataset_dir", str(tmp_path / "RefCOD"), "dataset_cfg.cache_dir", str(tmp_path / "cache"),
                "log_cfg.log_path", str(tmp_path / f"logs_{run}"), "dataset_cfg.trainset_cfg.DATASET", "TR-A+TR-B",
                "dataset_cfg.valset_cfg.DATASET", "TE-A", "dataset_cfg.trainset_cfg.image_size", "(56, 56)",
                "dataset_cfg.valset_cfg.image_size", "(56, 56)", "train_cfg.max_epoch", "2",
                "val_cfg.val_interval", "2", "val_cfg.val_start", "2"]

    wrappers = (packed_attention, layernorm_qkv, heads_attention, packed_attention_fwd_lse, packed_attention_bwd,
                layernorm_fc1_gelu, FL.layernorm_qkv_w8a8, FL.layernorm_fc1_gelu_w8a8, FL.dense_quant_w8a8,
                FL.layernorm_mlp_w8a8)
    files = {}
    for run, builds in (("a", True), ("b", False)):
        for fn in wrappers:
            fn.launches = 0
        runner = cli.lt_train_main(argv(run))
        # train: 1 feature batch, 4 grid-patch and 4 m-patch calls (one image
        # each); val: 1 feature batch and 2 grid-patch calls; 2 a fallback
        forwards = (1 + 4 + 4 + 1 + 2 if builds else 0) + 2 * runner.evaluator.crops
        assert packed_attention.launches == layernorm_qkv.launches == 11 * forwards
        assert not any(fn.launches for fn in wrappers[2:])
        losses = runner.train_loop.epoch_losses
        assert len(losses) == 2 and np.isfinite(losses).all()
        assert all(np.isfinite(v) and 0 <= v <= 1 for v in runner.evaluator.result.values())
        ckp = tmp_path / f"logs_{run}" / "refiner_ckp"
        files[run] = {f.name: load_file(str(f)) for f in sorted(ckp.iterdir())}
    assert sorted(files["a"]) == [f"epoch{e}{s}.safetensors" for e in (1, 2) for s in ("", "_ema")]
    for name, tensors in files["a"].items():
        for key, t in tensors.items():
            assert torch.equal(t, files["b"][name][key]), f"{name} {key} differs between two runs"
    first, last = files["a"]["epoch1.safetensors"], files["a"]["epoch2.safetensors"]
    assert any(not torch.equal(first[k], last[k]) for k in first)
