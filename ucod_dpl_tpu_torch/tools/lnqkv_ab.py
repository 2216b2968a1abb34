"""Same-process timing of K6 (fused LayerNorm + q/k/v) on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.lnqkv_ab [--parent DIR] [--variants] [--sass]

It answers on the card what the TPU prototypes
``scripts/microbench/bench_lnqkv.py`` (the fused kernel against the separate
LayerNorm + projections, and its row-block sweep, BQ 256/512/704) and
``scripts/microbench/bench_patch_lnqkv.py`` (fused against separate at the
serving shape) asked.  Always: the card's name and power limit
(nvidia-smi), then at bs16 L1370 (518px) and bs4 L2917 (756px), D 768 ->
3 x 768, bf16: K6 against its plain version (LayerNorm, then three cuBLAS
products and their bias adds: what the card runs without K6), interleaved,
beside one cuBLAS product of the normalised h with the concatenated
(2304, 768) weight (the GEMM alone: a yardstick, K6 computes more), K6's
largest difference from the plain version, and a torch.profiler breakdown
of K6's two kernels (statistics pre-pass, main loop).

* ``--parent DIR``: K6 of a parent checkout whose ``ucod_layernorm_qkv``
  takes no statistics scratch, built from DIR by DIR's own
  ``ops/_build.py``, timed against this tree's, interleaved parent, this,
  this, parent; the outputs of the two are compared.
* ``--variants``: edits of ``csrc/layernorm_qkv.cu`` (``VARIANTS``), built
  into ``build/ucod_dpl_tpu_torch/lnqkv_variants/`` and timed interleaved
  against this tree's kernel.  The prototype's row-block sweep becomes the
  work tile's shape and pipeline here (128 x 128 output tiles, two
  stages, one CTA per work tile); variants marked "diagnostic" compute a
  wrong result on purpose: they show what one part costs.
* ``--sass``: instruction counts in the SASS of the built
  ``layernorm_qkv.o``, in all and per kernel: HGMMA (wgmma), UTMALDG (TMA
  loads), HMMA (mma.sync).

Exits 1 without a CUDA device.  Times are CUDA-event means over 20 calls
after 3 warm-ups, each the mean of its two interleaved runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops import _build
from ucod_dpl_tpu_torch.ops import fused_layers as FL
from ucod_dpl_tpu_torch.tools.attention_ab import (
    _ab_ms,
    _chain,
    _log,
    _parent_lib,
    _stream,
    _sub,
    _time_ms,
    build_variants,
    sass_counts,
)

D, EPS = 768, 1e-6
SHAPES = ((16, 1370), (4, 2917))


def _inputs(b: int, l: int, seed: int = 0):
    """bf16 x and weights, f32 LayerNorm params and biases (the dtypes the
    serving backbone holds)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, l, D, generator=g, device="cuda").to(torch.bfloat16)
    norm = {"scale": 1 + 0.1 * torch.randn(D, generator=g, device="cuda"),
            "bias": 0.1 * torch.randn(D, generator=g, device="cuda")}
    lins = [{"w": (torch.randn(D, D, generator=g, device="cuda") / D ** 0.5).to(torch.bfloat16),
             "b": 0.1 * torch.randn(D, generator=g, device="cuda")} for _ in range(3)]
    return x, norm, lins


def _pointers(x, norm, lins, outs):
    """The C entry's pointer arguments, x to the three outputs."""
    return [t.data_ptr() for t in (x, norm["scale"], norm["bias"], *(p["w"] for p in lins),
                                   *(p["b"] for p in lins), *outs)]


def _max_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def fused_vs_separate(results: dict) -> None:
    for b, l in SHAPES:
        x, norm, lins = _inputs(b, l)
        h = FL.layer_norm(x, norm, EPS)
        w_cat = torch.cat([p["w"] for p in lins])
        k6, plain = _ab_ms(lambda: FL.layernorm_qkv(x, norm, *lins, EPS),
                           lambda: FL.layernorm_qkv_reference(x, norm, *lins, EPS))
        row = {"K6": k6, "plain": plain, "gemm_alone": _time_ms(lambda: F.linear(h, w_cat)),
               "max_abs_diff": _max_diff(FL.layernorm_qkv(x, norm, *lins, EPS),
                                         FL.layernorm_qkv_reference(x, norm, *lins, EPS)),
               "K6_tflops": 2.0 * b * l * D * 3 * D / k6 / 1e9}
        results[f"bs{b} L{l}"] = row
        _log(f"bs{b} L{l} D{D}: K6 {k6:.4f} ms ({row['K6_tflops']:.1f} TFLOP/s), plain LN + 3 cuBLAS products "
             f"{plain:.4f} ms, cuBLAS GEMM alone {row['gemm_alone']:.4f} ms; K6 vs plain max_abs_diff "
             f"{row['max_abs_diff']:.4g}")


def trace(results: dict) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, norm, lins = _inputs(16, 1370)
    for _ in range(2):
        FL.layernorm_qkv(x, norm, *lins, EPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            FL.layernorm_qkv(x, norm, *lins, EPS)
        torch.cuda.synchronize()
    _log("K6 bs16 L1370, device time per call by kernel (torch.profiler, 5 calls):")
    for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total):
        results[f"trace {e.key[:60]}"] = e.self_device_time_total / 5e3
        _log(f"  {e.self_device_time_total / 5e3:.4f} ms  {e.key[:100]}")


def parent_ab(parent: Path, results: dict) -> None:
    lib = _parent_lib(parent)

    def old(x, norm, lins):
        outs = [torch.empty_like(x) for _ in range(3)]
        _build.check_cuda(lib.ucod_layernorm_qkv(*_pointers(x, norm, lins, outs), x.numel() // D, D, EPS, _stream()),
                          "parent layernorm_qkv")
        return outs

    _log(f"parent {parent} against this tree (interleaved parent, this, this, parent):")
    for b, l in SHAPES:
        x, norm, lins = _inputs(b, l)
        ms = _ab_ms(lambda: old(x, norm, lins), lambda: FL.layernorm_qkv(x, norm, *lins, EPS))
        diff = _max_diff(old(x, norm, lins), FL.layernorm_qkv(x, norm, *lins, EPS))
        results[f"parent bs{b} L{l}"] = {"parent_ms": ms[0], "this_ms": ms[1], "max_abs_diff": diff}
        _log(f"  bs{b} L{l} K6: parent {ms[0]:.4f} ms, this {ms[1]:.4f} ms ({ms[0] / ms[1]:.3f}x); "
             f"largest difference {diff:.4g}")


# name -> (source file, what it changes, edit)
VARIANTS = {
    "n128": ("layernorm_qkv.cu", "128 x 128 output tiles (wgmma m64n128k16)",
             _sub("constexpr int kBlockN = 256;", "constexpr int kBlockN = 128;")),
    "stages2": ("layernorm_qkv.cu", "a two-stage ring",
                _sub("constexpr int kStages = 3;", "constexpr int kStages = 2;")),
    "grid": ("layernorm_qkv.cu", "one CTA per work tile (not persistent)",
             _sub("n_work < n_sm ? n_work : n_sm", "n_work")),
    "no_pdl": ("layernorm_qkv.cu", "the main kernel launched after the pre-pass ends (no programmatic dependent launch)",
               _sub("pdl.val.programmaticStreamSerializationAllowed = 1;",
                    "pdl.val.programmaticStreamSerializationAllowed = 0;")),
    "no_norm": ("layernorm_qkv.cu", "diagnostic: A = x as it is, no LayerNorm arithmetic",
                _sub("  return ucod::pack_bf16x2((f.x - st.x) * st.y * gb.x + gb.y, (f.y - st.x) * st.y * gb.z + gb.w);",
                     "  return (void)f, raw;")),
    "no_w_load": ("layernorm_qkv.cu", "diagnostic: no W tile loads (the products read stale W)",
                  _chain(_sub("ucod::mbar_expect_tx(&sm.full[st], kStageBytes);",
                              "ucod::mbar_expect_tx(&sm.full[st], kBlockM * kBlockK * 2);"),
                         _sub("          ucod::tma_load_3d(sm.w[st], tm_w, &sm.full[st], kt * kBlockK, col - which * d, 0);\n",
                              ""))),
    "stages4": ("layernorm_qkv.cu", "diagnostic: a four-stage ring, every output box staged in one 8 KB box",
                _chain(_sub("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
                       _sub("bf16 out[kConsumers][kBlockN / 64][64 * 64];", "bf16 out[kConsumers][1][64 * 64];"),
                       _sub("uint8_t* box = stage + (j / 8) * 64 * 64 * 2 + ", "uint8_t* box = stage + "),
                       _sub("ucod::tma_store_3d(tm_o, sm.out[c][a], n0 + 64 * a, m0, 0);",
                            "ucod::tma_store_3d(tm_o, sm.out[c][0], n0 + 64 * a, m0, 0);"))),
    "no_store": ("layernorm_qkv.cu", "diagnostic: the outputs staged but not stored",
                 _sub("for (int a = 0; a < kBlockN / 64; ++a) ucod::tma_store_3d(tm_o, sm.out[c][a], n0 + 64 * a, m0, 0);",
                      "(void)tm_o;")),
}


def variants(results: dict) -> None:
    names = list(VARIANTS)
    lib = build_variants(names, VARIANTS, ("ucod_layernorm_qkv",), "lnqkv_variants")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _log("variants of this tree's K6 (interleaved this, variant, variant, this):")
    for b, l in SHAPES:
        x, norm, lins = _inputs(b, l)
        ref = FL.layernorm_qkv(x, norm, *lins, EPS)
        for name in names:
            fn = getattr(lib, f"ucod_layernorm_qkv_{name}")
            fn.argtypes = [ptr] * 13 + [i32, i32, f32, ptr]

            def run(fn=fn):
                outs = [torch.empty_like(x) for _ in range(3)]
                stats = torch.empty(b * l, 2, device="cuda")
                _build.check_cuda(fn(*_pointers(x, norm, lins, outs), stats.data_ptr(), b * l, D, EPS, _stream()),
                                  name)
                return outs

            diff = _max_diff(run(), ref)
            base_ms, ms = _ab_ms(lambda: FL.layernorm_qkv(x, norm, *lins, EPS), run)
            _log(f"  bs{b} L{l} {name} ({VARIANTS[name][1]}): {ms:.4f} ms against {base_ms:.4f} ms; "
                 f"largest difference {diff:.4g}")
            results[f"variant {name} bs{b} L{l}"] = {"ms": ms, "this_ms": base_ms, "max_abs_diff": diff}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of the parent tree to time against")
    parser.add_argument("--variants", action="store_true", help="time the source variants in VARIANTS")
    parser.add_argument("--sass", action="store_true", help="count instructions in layernorm_qkv.o's SASS")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lnqkv_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": smi}
    if args.sass:
        sass_counts(results, sources=("layernorm_qkv",))
    fused_vs_separate(results)
    trace(results)
    if args.parent is not None:
        parent_ab(args.parent, results)
    if args.variants:
        variants(results)
    _log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
