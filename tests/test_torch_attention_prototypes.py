"""The eight TPU attention prototypes of ``scripts/microbench`` against the
plain functions of the K1 variants that port them (``tools/attention_ab.py``:
``SITES``, ``plain_of``).

Each prototype's ``pallas_call`` runs in interpret mode at B 1, 12 heads of
64 (D 768, the scripts' width), L 256, on seeded bf16 inputs, and is held
against the plain function of its variant: K1's own plain version where the
variant computes K1's function, else the variant's (``no_mask``,
``no_softmax``, ``scaled_q``, ``shift``).  Bound: elementwise rtol = atol =
0.05 (the repo's bf16 attention bound, tests/test_dino_parity.py) and
max|prototype - plain| within 2^-6 of max|plain| (chip_smoke.py's K1 bound);
both sides round p and o to bf16, so they differ by one bf16 ulp of an
output at most (measured 0.0039 at max|o| 0.86, and 0.125 at 84.5 without
the softmax).  ``shift`` is also held against the JAX production kernel
(``_pallas_attention_packed``, rowmax=False).

The prototypes that pad their inputs (bench_attention.py, 2 and 4) run at a
ragged L (200) too.  Those that do not pad (bench_attention5/6/7.py) return
NaN in every element there: interpret mode, like Mosaic's boundary blocks,
leaves the K/V rows past L undefined (NaN here), and these kernels neither
pad nor zero them, so a NaN score reaches every row's sum.
``bench_attention_756.py::packed_block`` (taken from its syntax tree:
importing the script runs a bs8 L2917 timing) calls the production kernel,
which zeroes those rows, but without its ``rowmax`` argument, which the
kernel has since gained: as written it raises TypeError.  With the argument
bound (both values) it holds, at L 256 and 200.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ucod_dpl_tpu.ops import attention as JA
from ucod_dpl_tpu_torch.ops.attention import packed_attention_reference
from ucod_dpl_tpu_torch.tools import attention_ab as AB

MICRO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "microbench")
HEADS, SCALE = 12, 0.125  # the scripts' NH and SCALE (1 / sqrt(64))


def _load(name: str):
    """Import a microbench script by path, with ``scripts/microbench`` on
    ``sys.path`` while it loads (bench_attention4.py imports
    bench_attention2); the saved path is put back afterwards, as is any
    entry a script inserts."""
    spec = importlib.util.spec_from_file_location(f"microbench_{name}", os.path.join(MICRO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    saved = sys.path[:]
    sys.path.insert(0, MICRO)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


@pytest.fixture(scope="module")
def proto():
    return {name: _load(name) for name in ("bench_attention", "bench_attention2", "bench_attention4",
                                           "bench_attention5", "bench_attention6", "bench_attention7")}


def _packed_block(rowmax=None):
    """``bench_attention_756.py::packed_block`` from the script's syntax tree,
    its ``A`` the JAX attention module, or with ``rowmax`` a stand-in whose
    ``_attention_kernel_headpair`` has that argument bound."""
    path = os.path.join(MICRO, "bench_attention_756.py")
    tree = ast.parse(open(path).read(), path)
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "packed_block"]
    a = JA if rowmax is None else types.SimpleNamespace(
        _ceil_to=JA._ceil_to, _attention_kernel_headpair=functools.partial(JA._attention_kernel_headpair,
                                                                         rowmax=rowmax))
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "A": a}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns["packed_block"]


def _inputs(l: int, seed: int):
    """q, k, v: (1, l, 768) normal values rounded to bf16, as f32 numpy."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.standard_normal((1, l, HEADS * 64)), jnp.bfloat16).astype(jnp.float32))
            for _ in range(3)]


def _run(fn, qkv):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(x, jnp.bfloat16) for x in qkv))
    return np.asarray(jnp.asarray(out).astype(jnp.float32))


def _plain(variant: str, qkv) -> np.ndarray:
    q, k, v = (torch.from_numpy(np.array(x)).to(torch.bfloat16) for x in qkv)
    return AB.plain_of(variant)(q, k, v, HEADS, SCALE).float().numpy()


def _assert_close(want: np.ndarray, got: np.ndarray):
    assert np.isfinite(want).all() and want.shape == got.shape
    np.testing.assert_allclose(want, got, rtol=0.05, atol=0.05)
    assert np.abs(want - got).max() <= 2.0 ** -6 * np.abs(got).max()


# (id, the variant whose plain function the prototype computes, "K1" for
# bench_attention7.py's row-max control, a call of the prototype modules ->
# fn(q, k, v)); the prototypes of the first group pad their inputs and run
# at L 256 and 200, those of the second at L 256
PADDED = [
    ("bench_attention.py:107 v2 block_q 128", "fwd_rows64",
     lambda p: p["bench_attention"].make_packed(p["bench_attention"]._kernel_v2, 128, 0, nomask=False)),
    ("bench_attention.py:107 v2 block_q 256 pad 384", "fwd_rows192",
     lambda p: p["bench_attention"].make_packed(p["bench_attention"]._kernel_v2, 256, 384, nomask=False)),
    ("bench_attention.py:107 v2 nomask", "fwd_no_mask",
     lambda p: p["bench_attention"].make_packed(p["bench_attention"]._kernel_v2, 128, 0, nomask=True)),
    ("bench_attention.py:107 nosoftmax", "fwd_no_softmax",
     lambda p: p["bench_attention"].make_packed(p["bench_attention"]._kernel_nosoftmax, 128, 0)),
    ("bench_attention2.py:87 v3", "fwd_head_pair", lambda p: p["bench_attention2"].make_v3(128)),
    ("bench_attention2.py:87 v3 lp 384", "fwd_tma_store", lambda p: p["bench_attention2"].make_v3(128, 384)),
    ("bench_attention2.py:87 v3 block_q 64", "fwd_head_pair_tma_store", lambda p: p["bench_attention2"].make_v3(64)),
    ("bench_attention2.py:146 v4", "fwd_q_loop", lambda p: p["bench_attention2"].make_v4(128)),
    ("bench_attention4.py:63 v5", "fwd_scale_q", None),  # its L set to the test's (below)
]
UNPADDED = [
    *((f"bench_attention5.py:82 additive {am} exp2 {e2}", "fwd_expf" if e2 else "fwd_mask_every_tile",
       lambda p, am=am, e2=e2: lambda q, k, v: p["bench_attention5"].packed_variant(q, k, v, HEADS, SCALE, am, e2))
      for am in (False, True) for e2 in (False, True)),
    *((f"bench_attention6.py:90 interleave {il}", "fwd_no_overlap",
       lambda p, il=il: lambda q, k, v: p["bench_attention6"].packed(q, k, v, HEADS, SCALE, 128, il))
      for il in (False, True)),
    *((f"bench_attention7.py:83 variant {var}", variant,
       lambda p, var=var: lambda q, k, v: p["bench_attention7"].packed(q, k, v, HEADS, SCALE, var))
      for var, variant in (("A", "K1"), ("B", "fwd_shift"), ("C", "fwd_shift_bf16"))),
]


def _prototype(case, proto, l):
    if case[2] is not None:
        return case[2](proto)
    b4 = proto["bench_attention4"]
    b4.L = l  # make_v5 asserts its padded length covers the module's L
    return b4.make_v5(128, 256)


@pytest.mark.parametrize("l", [256, 200])
@pytest.mark.parametrize("case", PADDED, ids=[c[0] for c in PADDED])
def test_padded_prototype_matches_its_variants_plain_function(proto, case, l):
    qkv = _inputs(l, l)
    _assert_close(_run(_prototype(case, proto, l), qkv), _plain(case[1], qkv))


@pytest.mark.parametrize("case", UNPADDED, ids=[c[0] for c in UNPADDED])
def test_unpadded_prototype_matches_its_variants_plain_function(proto, case):
    qkv = _inputs(256, 7)
    _assert_close(_run(case[2](proto), qkv), _plain(case[1], qkv))


@pytest.mark.parametrize("case", UNPADDED, ids=[c[0] for c in UNPADDED])
def test_unpadded_prototype_is_nan_at_a_ragged_length(proto, case):
    """At L 200 the K/V rows 200..255 of the last block are undefined (NaN
    in interpret mode) and neither padded nor zeroed: every output is NaN.
    The port's variants read no row past L (TMA zero-fills it)."""
    out = _run(case[2](proto), _inputs(200, 7))
    assert out.shape == (1, 200, HEADS * 64)
    assert np.isnan(out).all()


def test_756_prototype_as_written_misses_the_kernels_rowmax_argument():
    qkv = _inputs(256, 3)
    with pytest.raises(TypeError, match="rowmax"):
        _run(lambda q, k, v: _packed_block()(q, k, v, HEADS, SCALE, 128), qkv)


@pytest.mark.parametrize("l", [256, 200])
@pytest.mark.parametrize("block_q", [128, 256])
@pytest.mark.parametrize("rowmax,variant", [(True, "fwd_rows192"), (False, "fwd_shift_bf16")])
def test_756_prototype_with_rowmax_matches_its_variants_plain_function(rowmax, variant, block_q, l):
    """rowmax=True: the row-max kernel, K1's function (the row variants'
    site); rowmax=False: the production default, the constant shift."""
    qkv = _inputs(l, l + block_q)
    fn = _packed_block(rowmax)
    _assert_close(_run(lambda q, k, v: fn(q, k, v, HEADS, SCALE, block_q), qkv), _plain(variant, qkv))


@pytest.mark.parametrize("l", [256, 200])
def test_shift_is_the_jax_production_kernels_function(l):
    """``shift`` (bf16 sum) against ``_pallas_attention_packed`` with its
    default rowmax=False, which pads in interpret mode."""
    qkv = _inputs(l, 11 + l)
    want = _run(lambda q, k, v: JA._pallas_attention_packed(q, k, v, HEADS, SCALE, rowmax=False), qkv)
    _assert_close(want, _plain("fwd_shift_bf16", qkv))


def test_every_site_is_a_pallas_call_with_a_variant_and_a_plain_function():
    """Each prototype site named in ``SITES`` is a ``pl.pallas_call`` line of
    its script; the eight are every such line of the bench_attention
    scripts but bench_attention3.py's (which calls the JAX package's own
    kernel); each has at least one variant in ``VARIANTS``, which computes
    K1's function or has a plain function of its own."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sites = set()
    for name in sorted(os.listdir(MICRO)):
        if name.startswith("bench_attention") and name.endswith(".py") and name != "bench_attention3.py":
            for i, line in enumerate(open(os.path.join(MICRO, name)), 1):
                if "pl.pallas_call(" in line:
                    sites.add(f"scripts/microbench/{name}:{i}")
    assert set(AB.SITES) == sites and len(sites) == 8
    assert set(AB.PROTO_VARIANTS) == {v for _, variants in AB.SITES.values() for v in variants}
    for site, (_, variants) in AB.SITES.items():
        path, line = site.rsplit(":", 1)
        assert "pl.pallas_call(" in open(os.path.join(root, path)).read().splitlines()[int(line) - 1]
        assert variants and all(v in AB.VARIANTS and v in AB.PROTO_VARIANTS for v in variants)
        assert all(callable(AB.plain_of(v)) for v in variants)


def test_plain_functions_at_a_glance():
    """The diagnostics' and the shift's plain functions against direct
    forms: no_mask is K1's function with the zero keys appended to k and v;
    no_softmax is q k^T scale v; the shift with the f32 sum is the softmax
    (shift invariance) up to bf16 p; scaled_q is K1's on the pre-rounded q."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 70, 128, generator=g).to(torch.bfloat16) for _ in range(3))
    zeros = torch.zeros(2, 58, 128, dtype=torch.bfloat16)
    pad = [torch.cat([x, zeros], 1) for x in (q, k, v)]
    ulp = 2.0 ** -8  # one bf16 ulp, relative: the products' f32 sums in another order may round apart

    def close(got, want):
        return (got.float() - want.float()).abs().max() <= ulp * want.float().abs().max()

    assert close(AB.no_mask(q, k, v, 2, SCALE), packed_attention_reference(*pad, 2, SCALE)[:, :70])
    heads = [x.float().view(2, 70, 2, 64).transpose(1, 2) for x in (q, k, v)]
    direct = ((heads[0] @ heads[1].transpose(-1, -2) * SCALE).to(torch.bfloat16).float() @ heads[2])
    assert close(AB.no_softmax(q, k, v, 2, SCALE), direct.transpose(1, 2).reshape(2, 70, 128))
    ref = packed_attention_reference(q, k, v, 2, SCALE)
    assert (AB.shift(q, k, v, 2, SCALE).float() - ref.float()).abs().max() <= 2.0 ** -7 * ref.float().abs().max()
    assert torch.equal(AB.scaled_q(q, k, v, 2, SCALE),
                       packed_attention_reference(AB.scale_q(q, SCALE), k, v, 2, math.log(2.0)))
