"""The ports of the serving forward's two TPU fusion prototypes against them.

K12 (``ops/attention.py::attention_outproj_residual``) against
``scripts/microbench/bench_attn_outproj.py``: its Pallas kernel ``fused``
where L is a multiple of 128 (bf16 within 0.05, the repo's bf16 attention
bound, tests/test_dino_parity.py), and its composed path ``ref`` (the
packed attention kernel, the out-projection, the layerscale and the
residual) at a ragged L, where ``fused`` multiplies its unsanitised padded
V tail by p = 0 and returns NaN, while the port leaves keys past L out.
The composed path rounds the attention output's product before its bias
and the layerscale's and residual's results as well; measured 0.0156
apart at max|out| 4.6-4.8 (L 200, 130), one bf16 ulp of an output in
[2, 4); the bound is one bf16 ulp of max|ref|, at most 2^-7 of it.

K13 (``ops/patch_embed.py::patch_embed``) against
``bench_patch_embed3.py::pallas_im2col`` and ``conv_current`` in f32
(within 1e-5, tests/test_dino_parity.py's f32 bound; measured 2.3e-6), at
518px with the module's batch B set to 2 and at 224px (its image globals
set to match), with and without the position rows, and against
``bench_patch_embed.py``'s ``pallas_patch`` and ``pallas_patch2`` in bf16
(one bf16 ulp of max|y|; measured 0.0039 at max 2.45), run from their
definitions and the constants they read in the script's syntax tree
(importing the script runs its 518px timings).  The JAX side runs its
Pallas kernels in interpret mode.  Both kernels substituted into the ViT
(K13 for the patch embed, K12 for the first layer's attention half) hold
the JAX forward's key tokens in f32.  CPU tensors take the plain versions
and count no launch.
"""

from __future__ import annotations

import ast
import importlib.util
import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.ops.attention import attention_outproj_residual, attention_outproj_residual_reference
from ucod_dpl_tpu_torch.ops.fused_layers import dense, layer_norm, layernorm_qkv
from ucod_dpl_tpu_torch.ops.patch_embed import patch_embed, patch_embed_reference, pqc_weight

MICRO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "microbench")
D, HEADS, SCALE = 768, 12, 0.125  # bench_attn_outproj.py's module constants


def _load(name: str):
    """Import a microbench script by path.  The scripts put a path of their
    own (``bench_attn_outproj.py`` a fixed absolute one) at the front of
    ``sys.path`` when imported; the saved path is put back, so later imports
    in this process resolve inside this checkout.  The modules they import
    from the JAX package are imported above, from this checkout."""
    spec = importlib.util.spec_from_file_location(f"microbench_{name}", os.path.join(MICRO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    saved = sys.path[:]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


@pytest.fixture(scope="module")
def outproj_proto():
    return _load("bench_attn_outproj")


@pytest.fixture(scope="module")
def im2col_proto():
    return _load("bench_patch_embed3")


def _patch_script(batch: int, bias: np.ndarray) -> dict:
    """``bench_patch_embed.py``'s ``pallas_patch``, ``pallas_patch2`` and
    ``conv`` with the constants they read (B, IMG, P, D, G, dt), taken from
    the script's syntax tree, at batch ``batch`` and with bias ``bias``."""
    path = os.path.join(MICRO, "bench_patch_embed.py")
    tree = ast.parse(open(path).read(), path)
    consts = {"B", "IMG", "P", "D", "G", "dt"}

    def stored(node):
        return {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}

    keep = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in {"_patch_kernel", "pallas_patch", "_patch_kernel2",
                                                              "pallas_patch2", "conv"}
            or isinstance(n, ast.Assign) and stored(n) <= consts]
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns.update(B=batch, bias=jnp.asarray(bias))
    return ns


def _outproj_inputs(b: int, l: int, seed: int):
    """numpy q, k, v, x (bf16 values) and the prototype's (in, out) weight,
    (1, D) bias and layerscale."""
    rng = np.random.default_rng(seed)
    qkvx = [np.array(jnp.asarray(rng.standard_normal((b, l, D)), jnp.bfloat16).astype(jnp.float32))
            for _ in range(4)]
    wo = (rng.standard_normal((D, D)) * 0.02).astype(np.float32)
    bo = (rng.standard_normal((1, D)) * 0.1).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, (1, D)).astype(np.float32)
    return qkvx, (wo, bo, ls)


def _both(qkvx, params, proto, fn_name):
    """(the prototype's ``fn_name`` output, the port's plain output), f32."""
    jq, jk, jv, jx = (jnp.asarray(a, jnp.bfloat16) for a in qkvx)
    with pltpu.force_tpu_interpret_mode():
        want = getattr(proto, fn_name)(tuple(map(jnp.asarray, params)), jq, jk, jv, jx)
    wo, bo, ls = (torch.from_numpy(a) for a in params)
    q, k, v, x = (torch.from_numpy(a).to(torch.bfloat16) for a in qkvx)
    got = attention_outproj_residual(q, k, v, x, wo.t().contiguous(), bo[0], ls[0], HEADS, SCALE)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("b,l", [(1, 256), (2, 128)])
def test_attention_outproj_matches_the_prototype_kernel(outproj_proto, b, l):
    want, got = _both(*_outproj_inputs(b, l, l + b), outproj_proto, "fused")
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= 0.05


@pytest.mark.parametrize("l", [200, 130])
def test_attention_outproj_at_a_ragged_length_matches_the_composed_prototype(outproj_proto, l):
    want, got = _both(*_outproj_inputs(1, l, l), outproj_proto, "ref")
    assert np.isfinite(got).all()
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp


def _pixels(b: int, size: int, seed: int):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    pe = (rng.standard_normal((14, 14, 3, D)) * 0.02).astype(np.float32)  # HWIO, the JAX layout
    bias = (rng.standard_normal((D,)) * 0.01).astype(np.float32)
    pos = (rng.standard_normal(((size // 14) ** 2, D)) * 0.01).astype(np.float32)
    return px, pe, bias, pos


@pytest.mark.parametrize("size,with_pos", [(518, True), (224, True), (224, False)])
def test_patch_embed_matches_the_im2col_prototype_in_f32(im2col_proto, monkeypatch, size, with_pos):
    gw = size // 14
    for name, value in (("B", 2), ("IMG", size), ("GW", gw), ("L", gw * gw)):
        monkeypatch.setattr(im2col_proto, name, value)
    px, pe, bias, pos = _pixels(2, size, size)
    jpos = pos if with_pos else np.zeros_like(pos)
    args = (jnp.asarray(px), jnp.asarray(pe.reshape(588, D)), jnp.asarray(bias), jnp.asarray(jpos))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(im2col_proto.pallas_im2col(*args))
    conv = np.asarray(im2col_proto.conv_current(jnp.asarray(px), jnp.asarray(pe), *args[2:]))
    got = patch_embed(torch.from_numpy(px), torch.from_numpy(pe.reshape(588, D)), torch.from_numpy(bias),
                      torch.from_numpy(pos) if with_pos else None).numpy()
    assert got.shape == want.shape == (2, gw * gw, D)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(got - conv).max() <= 1e-5


@pytest.mark.parametrize("fn", ["pallas_patch", "pallas_patch2"])
def test_patch_embed_matches_the_matmul_prototypes_in_bf16(fn):
    px, pe, bias, _ = _pixels(2, 518, 7)
    script = _patch_script(2, bias)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script[fn](jnp.asarray(pe), jnp.asarray(px)).astype(jnp.float32))
    got = patch_embed(torch.from_numpy(px), torch.from_numpy(pe.reshape(588, D)).to(torch.bfloat16),
                      torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= ulp


def test_pqc_weight_is_the_jax_kernel_in_im2col_order():
    """The port's (D, 3, 14, 14) kernel, converted from the JAX (14, 14, 3,
    D) one, maps back to the JAX kernel's (588, D) reshape exactly."""
    pe = np.random.default_rng(3).standard_normal((14, 14, 3, D)).astype(np.float32)
    kernel = C.dino_from_jax({"patch_embed": {"kernel": pe, "bias": np.zeros(D, np.float32)},
                              "cls_token": np.zeros((1, 1, D), np.float32),
                              "pos_embed": np.zeros((1, 5, D), np.float32), "layers": [],
                              "final_norm": {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}}
                             )["patch_embed"]["kernel"]
    assert tuple(kernel.shape) == (D, 3, 14, 14)
    assert torch.equal(pqc_weight(kernel), torch.from_numpy(pe.reshape(588, D)))


@pytest.fixture(scope="module")
def tiny():
    """hidden 256 (K12's kernel takes D % 256 == 0), 4 heads of 64, 2 layers:
    the first is a whole layer, the second the cut last layer."""
    cfg = JD.DinoConfig(variant="dinov2", image_size=56, patch_size=14, hidden_size=256,
                        num_layers=2, num_heads=4, mlp_ratio=4)
    tcfg = TD.DinoConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = JD.init_dino(jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, jp, C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _forward_with_prototypes(p, px: torch.Tensor, cfg) -> torch.Tensor:
    """The f32 ViT's key tokens with K13 as the patch embed and K12 as the
    first layer's attention half (models/dino.py's composition otherwise)."""
    b, h, w, _ = px.shape
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    orig = int(round((p["pos_embed"].shape[1] - 1) ** 0.5))
    pos = TD.interpolate_pos_embed(p["pos_embed"], (gh, gw), orig)[0]
    tokens = patch_embed(px, pqc_weight(p["patch_embed"]["kernel"]), p["patch_embed"]["bias"], pos[1:])
    x = torch.cat([(p["cls_token"].reshape(1, 1, -1) + pos[:1]).expand(b, 1, -1), tokens], dim=1)
    layer, last = p["layers"]
    eps = cfg.layer_norm_eps
    q, k, v = layernorm_qkv(x, layer["norm1"], layer["q"], layer["k"], layer["v"], eps)
    x = attention_outproj_residual(q, k, v, x, layer["out"]["w"], layer["out"]["b"], layer["ls1"],
                                   cfg.num_heads, cfg.head_dim ** -0.5)
    hid = F.gelu(dense(layer_norm(x, layer["norm2"], eps), layer["fc1"], torch.float32))
    x = x + dense(hid, layer["fc2"], torch.float32) * layer["ls2"]
    return dense(layer_norm(x, last["norm1"], eps), last["k"], torch.float32)


def test_both_prototypes_in_the_forward_hold_the_jax_key_tokens(tiny, monkeypatch):
    cfg, tcfg, jp, tp = tiny
    px = np.random.default_rng(4).standard_normal((2, 70, 56, 3)).astype(np.float32)
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    want = np.asarray(JD.dino_forward(jp, jnp.asarray(px), cfg)["key_tokens"])
    got = _forward_with_prototypes(tp, torch.from_numpy(px), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    g = torch.Generator().manual_seed(5)
    q, k, v, x = (torch.randn(2, 65, 256, generator=g).to(torch.bfloat16) for _ in range(4))
    wo = (torch.randn(256, 256, generator=g) / 16).to(torch.bfloat16)
    bo, ls = torch.randn(256, generator=g), torch.rand(256, generator=g)
    px = torch.randn(2, 28, 42, 3, generator=g)
    w = (0.02 * torch.randn(588, 256, generator=g)).to(torch.bfloat16)
    pos = torch.randn(6, 256, generator=g).to(torch.bfloat16)
    before = (attention_outproj_residual.launches, patch_embed.launches)
    out12 = torch.full_like(q, float("nan"))
    assert attention_outproj_residual(q, k, v, x, wo, bo, ls, 4, 0.125, out=out12) is out12
    assert torch.equal(out12, attention_outproj_residual_reference(q, k, v, x, wo, bo, ls, 4, 0.125))
    out13 = torch.full((2, 6, 256), float("nan"), dtype=torch.bfloat16)
    assert patch_embed(px, w, bo, pos, out=out13) is out13
    assert torch.equal(out13, patch_embed_reference(px, w, bo, pos))
    assert (attention_outproj_residual.launches, patch_embed.launches) == before
