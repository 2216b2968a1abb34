"""Same-process timing of K6 (fused LayerNorm + q/k/v) and K7 (LayerNorm + fc1 + GELU) on the card.

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
of K6's two kernels (statistics pre-pass, main loop).  Then K7, an
instantiation of K6's main kernel (768 -> 3072, one weight, a GELU
epilogue), at the same shapes: against its plain version and against
LayerNorm + one cuBLAS product + GELU as a layer composes them (what the
card runs without K7), by events and by the card's own time
(``attention_ab._device_ms``), with its profiler split.  It answers what
the TPU prototype ``scripts/microbench/bench_lnfc1.py`` (the fused
LayerNorm + fc1 + GELU against the separate ops) asked.

* ``--parent DIR``: K6 and K7 of a parent checkout whose
  ``ucod_layernorm_qkv`` takes the statistics scratch and whose
  ``ucod_layernorm_fc1_gelu`` takes none (K7's first design), built from
  DIR by DIR's own ``ops/_build.py``, timed against this tree's, both
  through their C entries, interleaved parent, this, this, parent; the
  outputs of the two are compared (K6 must be bit for bit equal).  K6 in
  ``K6_ROUNDS`` such rounds, by events and by the card's own time, with
  each round's ratio and their spread.
* ``--variants``: edits of ``csrc/layernorm_qkv.cu`` (``VARIANTS``), built
  into ``build/ucod_dpl_tpu_torch/lnqkv_variants/`` and timed interleaved
  against this tree's kernel.  The prototype's row-block sweep becomes the
  work tile's shape and pipeline here (128 x 128 output tiles, two
  stages, one CTA per work tile); variants marked "diagnostic" compute a
  wrong result on purpose: they show what one part costs.
* ``--sass``: instruction counts in the SASS of the built
  ``layernorm_qkv.o``, in all and per kernel (``layernorm_gemm_kernel``
  <false> is K6, <true> K7): HGMMA (wgmma), UTMALDG (TMA loads), HMMA
  (mma.sync: none left).

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
import torch.nn.functional as TF

from ucod_dpl_tpu_torch.ops import _build
from ucod_dpl_tpu_torch.ops import fused_layers as FL
from ucod_dpl_tpu_torch.tools.attention_ab import (
    _ab_ms,
    _chain,
    _device_ms,
    _log,
    _parent_lib,
    _stream,
    _sub,
    _time_ms,
    build_variants,
    sass_counts,
)

D, F, EPS = 768, 3072, 1e-6
SHAPES = ((16, 1370), (4, 2917))
K6_ROUNDS = 7


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


def _fc1(seed: int = 1):
    """bf16 fc1 weight (F, D) and f32 bias, as the serving backbone holds them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"w": (torch.randn(F, D, generator=g, device="cuda") / D ** 0.5).to(torch.bfloat16),
            "b": 0.1 * torch.randn(F, generator=g, device="cuda")}


def _composed_up(x, norm, fc1):
    """LayerNorm, one cuBLAS product + bias, tanh GELU: the MLP's first half as
    the layer composes it without K7."""
    return TF.gelu(FL.dense(FL.layer_norm(x, norm, EPS), fc1, torch.bfloat16), approximate="tanh")


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
        row = {"K6": k6, "plain": plain, "gemm_alone": _time_ms(lambda: TF.linear(h, w_cat)),
               "max_abs_diff": _max_diff(FL.layernorm_qkv(x, norm, *lins, EPS),
                                         FL.layernorm_qkv_reference(x, norm, *lins, EPS)),
               "K6_tflops": 2.0 * b * l * D * 3 * D / k6 / 1e9}
        results[f"bs{b} L{l}"] = row
        _log(f"bs{b} L{l} D{D}: K6 {k6:.4f} ms ({row['K6_tflops']:.1f} TFLOP/s), plain LN + 3 cuBLAS products "
             f"{plain:.4f} ms, cuBLAS GEMM alone {row['gemm_alone']:.4f} ms; K6 vs plain max_abs_diff "
             f"{row['max_abs_diff']:.4g}")
        fc1 = _fc1()

        def k7(x=x):
            return FL.layernorm_fc1_gelu(x, norm, fc1, EPS)

        def k7_plain(x=x):
            return FL.layernorm_fc1_gelu_reference(x, norm, fc1, EPS)

        def composed(x=x):
            return _composed_up(x, norm, fc1)

        k7_ms, k7_plain_ms = _ab_ms(k7, k7_plain)
        composed_ms, k7_ms2 = _ab_ms(composed, k7)
        ref = k7_plain().float()
        r7 = {"K7": (k7_ms + k7_ms2) / 2, "plain": k7_plain_ms, "composed": composed_ms,
              "K7_device": _device_ms(k7), "plain_device": _device_ms(k7_plain), "composed_device": _device_ms(composed),
              "max_abs_diff": (k7().float() - ref).abs().max().item(), "max_abs_plain": ref.abs().max().item(),
              "gemm_alone_device": _device_ms(lambda h=h: TF.linear(h, fc1["w"]))}
        r7["K7_tflops"] = 2.0 * b * l * D * F / r7["K7_device"] / 1e9
        results[f"K7 bs{b} L{l}"] = r7
        _log(f"bs{b} L{l} D{D} F{F}: K7 {r7['K7_device']:.4f} ms device ({r7['K7_tflops']:.1f} TFLOP/s), "
             f"{r7['K7']:.4f} by events; LN + cuBLAS + GELU as composed {r7['composed_device']:.4f} ms device "
             f"({composed_ms:.4f} by events); plain {r7['plain_device']:.4f} ms device ({k7_plain_ms:.4f} by "
             f"events); cuBLAS fc1 GEMM alone {r7['gemm_alone_device']:.4f} ms device; K7 vs plain max_abs_diff "
             f"{r7['max_abs_diff']:.4g} (max |plain| {r7['max_abs_plain']:.4g})")


def trace(results: dict) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, norm, lins = _inputs(16, 1370)
    fc1 = _fc1()
    for kid, fn in (("K6", lambda: FL.layernorm_qkv(x, norm, *lins, EPS)),
                    ("K7", lambda: FL.layernorm_fc1_gelu(x, norm, fc1, EPS))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        _log(f"{kid} bs16 L1370, device time per call by kernel (torch.profiler, 5 calls):")
        for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total):
            results[f"trace {kid} {e.key[:60]}"] = e.self_device_time_total / 5e3
            _log(f"  {e.self_device_time_total / 5e3:.4f} ms  {e.key[:100]}")


def _k6_entry(fn, x, norm, lins):
    """A call of the C entry ``ucod_layernorm_qkv`` ``fn`` (its statistics
    scratch allocated per call, as the wrapper does), returning q, k, v."""
    def run():
        outs = [torch.empty_like(x) for _ in range(3)]
        stats = torch.empty(x.numel() // D, 2, device=x.device)
        _build.check_cuda(fn(*_pointers(x, norm, lins, outs), stats.data_ptr(), x.numel() // D, D, EPS, _stream()),
                          "layernorm_qkv")
        return outs
    return run


def _spread(ratios) -> dict:
    r = sorted(ratios)
    return {"rounds": ratios, "min": r[0], "median": r[len(r) // 2], "max": r[-1]}


def parent_ab(parent: Path, results: dict) -> None:
    lib = _parent_lib(parent)
    kernels = _build.kernels()
    _log(f"parent {parent} against this tree (interleaved parent, this, this, parent; both through their C entries):")
    for b, l in SHAPES:
        x, norm, lins = _inputs(b, l)
        old, new = _k6_entry(lib.ucod_layernorm_qkv, x, norm, lins), _k6_entry(kernels.ucod_layernorm_qkv, x, norm, lins)
        events, device = [], []
        for _ in range(K6_ROUNDS):
            ms = _ab_ms(old, new)
            d1, n1, n2, d2 = _device_ms(old), _device_ms(new), _device_ms(new), _device_ms(old)
            events.append(ms[0] / ms[1])
            device.append((d1 + d2) / (n1 + n2))
        row = {"parent_ms": ms[0], "this_ms": ms[1], "parent_device_ms": (d1 + d2) / 2,
               "this_device_ms": (n1 + n2) / 2, "events_ratio": _spread(events), "device_ratio": _spread(device),
               "max_abs_diff": _max_diff(old(), new()), "bit_equal": all(map(torch.equal, old(), new()))}
        results[f"parent bs{b} L{l}"] = row
        ev, dv = row["events_ratio"], row["device_ratio"]
        _log(f"  bs{b} L{l} K6, parent / this over {K6_ROUNDS} rounds: by events median {ev['median']:.3f}x "
             f"(min {ev['min']:.3f}, max {ev['max']:.3f}), device median {dv['median']:.3f}x (min {dv['min']:.3f}, "
             f"max {dv['max']:.3f}); last round parent {row['parent_device_ms']:.4f} ms device "
             f"({row['parent_ms']:.4f} by events), this {row['this_device_ms']:.4f} ({row['this_ms']:.4f}); "
             f"largest difference {row['max_abs_diff']:.4g}, bit for bit equal: {row['bit_equal']}")
        fc1 = _fc1()

        def k7_entry(scratch: bool, x=x):
            """A call of K7's C entry; the parent's takes no statistics scratch."""
            out = torch.empty(*x.shape[:-1], F, dtype=torch.bfloat16, device=x.device)
            stats = [torch.empty(x.numel() // D, 2, device=x.device)] if scratch else []
            fn = (kernels if scratch else lib).ucod_layernorm_fc1_gelu
            _build.check_cuda(fn(*(t.data_ptr() for t in (x, norm["scale"], norm["bias"], fc1["w"], fc1["b"], out,
                                                           *stats)), x.numel() // D, D, F, EPS, _stream()),
                              "layernorm_fc1_gelu")
            return out

        def old_k7():
            return k7_entry(False)

        def k7():
            return k7_entry(True)

        ms = _ab_ms(old_k7, k7)
        dev = (_device_ms(old_k7), _device_ms(k7))
        diff = (old_k7().float() - k7().float()).abs().max().item()
        results[f"parent K7 bs{b} L{l}"] = {"parent_ms": ms[0], "this_ms": ms[1], "parent_device_ms": dev[0],
                                            "this_device_ms": dev[1], "max_abs_diff": diff}
        _log(f"  bs{b} L{l} K7: parent {dev[0]:.4f} ms device ({ms[0]:.4f} by events), this {dev[1]:.4f} ms "
             f"device ({ms[1]:.4f} by events), {dev[0] / dev[1]:.3f}x; largest difference {diff:.4g}")


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
                         _sub("          ucod::tma_load_3d(sm.w[st], tm_w, &sm.full[st], kt * kBlockK, col - which * n, 0);\n",
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
