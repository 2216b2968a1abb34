"""Same-process timing of the int8 kernels K8-K11 on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.int8_ab [--parent DIR] [--variants [NAME ...]] [--sass]

Always: the card's name and power limit (nvidia-smi), the main kernels'
shared memory and how many K9 and K11 clusters the card holds at once
(``ucod_int8_kernel_info``, ``cudaOccupancyMaxActiveClusters``), then at
bs16 L1370 (518px) and bs4 L2917 (756px), D 768, F 3072, bf16 activations
and int8 weights: K8-K11 against their plain versions, interleaved; K11
against the split MLP half (K9's kernel, then ``dense_w8a8_pre``: fc2 as
``torch._int_mm`` and its f32 rescale), with their outputs compared bit for
bit; K8 against K6 (the bf16 LayerNorm + q/k/v kernel) on the same x, K6 on
the same layer's bf16 weights; the int8 GEMM alone (``torch._int_mm`` of the
codes with the concatenated (2304, 768) q/k/v weight and with the (3072,
768) fc1 weight: a yardstick, each kernel computes more); each kernel's
rate; and a torch.profiler split of each kernel's two launches (quantize
pre-pass, main kernel) at bs16 L1370.

* ``--parent DIR``: K8-K11 of a parent checkout whose K8-K10 entries take
  the pre-pass scratch and whose K11 entry takes none (K11's first design),
  unpacked with ``git archive``, built from DIR by DIR's own ``ops/_build.py``, timed against this tree's,
  interleaved this, parent, parent, this; the outputs of the two are
  compared (the share equal, the largest difference).  Also at bs8 and bs1
  L1370, the batches of a request of 5 and of 1 image (``Predictor``'s
  buckets), where a call's host time weighs most.
* ``--variants [NAME ...]``: edits of ``csrc/int8_linear.cu``
  (``VARIANTS``; all, or the ones named), built
  into ``build/ucod_dpl_tpu_torch/int8_variants/`` and timed interleaved
  against this tree's kernels; variants marked "diagnostic" compute a wrong
  result on purpose: they show what one part costs.
* ``--sass``: instruction counts in the SASS of the built
  ``int8_linear.o``, in all and per kernel: IGMMA (int8 wgmma), UTMALDG and
  UTMASTG (TMA loads and stores), IMMA (mma.sync: none left), and each
  kernel's registers and spills from ``build.log`` (ptxas -v), with any
  C7514 line (a wgmma ptxas serialized).

Exits 1 without a CUDA device.  Two times of each call: "by events", CUDA
events around 20 back-to-back calls after 3 warm-ups, each the mean of its
two interleaved runs (how earlier PRs timed every kernel; it holds the
host's time per call when that is the longer), and "device", CUDA events
around 20 calls queued behind a sleep kernel, so the card runs them back to
back (``attention_ab._device_ms``): the kernel's own time.  Beside them the
host's time per call (``_host_ms``).  Every A/B calls both sides through
the same path (the C entries, ``_entry_call``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from ucod_dpl_tpu_torch.ops import _build
from ucod_dpl_tpu_torch.ops import fused_layers as FL
from ucod_dpl_tpu_torch.ops.quant import dense_w8a8_pre, int8_matmul, quantize_act, quantize_linear
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
PEAK_INT8 = 1979e12
ENTRIES = ("ucod_layernorm_qkv_w8a8", "ucod_quant_dense_w8a8", "ucod_layernorm_fc1_gelu_w8a8",
           "ucod_layernorm_mlp_w8a8", "ucod_int8_kernel_info")


def _layer(seed: int = 0):
    """One layer at the serving widths: LayerNorm params, bf16 q/k/v for K6
    and the int8 q/k/v/out/fc1 quantized from the same f32 weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def lin(d_in, d_out):
        return {"w": torch.randn(d_out, d_in, generator=g, device="cuda") / d_in ** 0.5,
                "b": 0.1 * torch.randn(d_out, generator=g, device="cuda")}

    norm = {"scale": 1 + 0.1 * torch.randn(D, generator=g, device="cuda"),
            "bias": 0.1 * torch.randn(D, generator=g, device="cuda")}
    f32 = {name: lin(D, D) for name in ("q", "k", "v", "out")}
    f32["fc1"], f32["fc2"] = lin(D, F), lin(F, D)
    q8 = {name: quantize_linear(p) for name, p in f32.items()}
    bf16 = [{"w": f32[n]["w"].to(torch.bfloat16), "b": f32[n]["b"]} for n in "qkv"]
    return norm, q8, bf16


def _x(b: int, l: int, seed: int = 1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, l, D, generator=g, device="cuda").to(torch.bfloat16)


def _calls(x, norm, q8):
    """This tree's kernels and their plain versions, by kernel id."""
    qkv = (q8["q"], q8["k"], q8["v"])
    return {
        "K8": (lambda: FL.layernorm_qkv_w8a8(x, norm, *qkv, EPS),
               lambda: FL.layernorm_qkv_w8a8_reference(x, norm, *qkv, EPS)),
        "K9": (lambda: FL.layernorm_fc1_gelu_w8a8(x, norm, q8["fc1"], EPS),
               lambda: FL.layernorm_fc1_gelu_w8a8_reference(x, norm, q8["fc1"], EPS)),
        "K10": (lambda: FL.dense_quant_w8a8(x, q8["out"], torch.bfloat16),
                lambda: FL.dense_quant_w8a8_reference(x, q8["out"], torch.bfloat16)),
        "K11": (lambda: FL.layernorm_mlp_w8a8(x, norm, q8["fc1"], q8["fc2"], EPS),
                lambda: FL.layernorm_mlp_w8a8_reference(x, norm, q8["fc1"], q8["fc2"], EPS)),
    }


def _split_half(x, norm, q8):
    """The MLP half of the split path: K9's kernel, then fc2 as
    ``torch._int_mm`` with its f32 rescale (``int8_mlp="split"``)."""
    return dense_w8a8_pre(*FL.layernorm_fc1_gelu_w8a8(x, norm, q8["fc1"], EPS), q8["fc2"], torch.bfloat16)


def _host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The host's time per call of ``fn``: the wall clock around ``iters``
    calls with no wait on the card between them (checks, allocations, tensor
    maps, launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def _ops(kid: str, rows: int) -> float:
    return 2.0 * rows * D * {"K8": 3 * D, "K9": F, "K10": D, "K11": 2 * F}[kid]


def _compare(a, b) -> dict:
    """Share of equal elements and the largest difference over tuples of outputs."""
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    equal = sum((x == y).sum().item() for x, y in zip(a, b)) / sum(x.numel() for x in a)
    diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
    return {"equal": equal, "max_abs_diff": diff}


def info(results: dict) -> None:
    fn = _build.kernels().ucod_int8_kernel_info
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 5
    vals = [ctypes.c_int() for _ in range(5)]
    _build.check_cuda(fn(D, F, *(ctypes.byref(v) for v in vals)), "int8 kernel info")
    gemm, k9, k9_clusters, k11, k11_clusters = (v.value for v in vals)
    results["info"] = {"K8/K10 main smem": gemm, "K9 main smem": k9, "K9 clusters at once": k9_clusters,
                       "K11 main smem": k11, "K11 clusters at once": k11_clusters}
    _log(f"shared memory: K8/K10 main kernel {gemm} bytes, K9 main kernel (F {F}) {k9} bytes, K11 main kernel "
         f"(D {D}, F {F}) {k11} bytes; clusters the card holds at once: K9 {k9_clusters}, K11 {k11_clusters}")


def kernels_vs_plain(results: dict) -> None:
    norm, q8, bf16 = _layer()
    w_qkv = torch.cat([q8[n]["w_q"] for n in "qkv"])
    for b, l in SHAPES:
        x = _x(b, l)
        rows = b * l
        row = {}
        for kid, (kernel, plain) in _calls(x, norm, q8).items():
            plain_ms, ms = _ab_ms(plain, kernel)
            dev = _device_ms(kernel)
            row[kid] = {"ms": ms, "device_ms": dev, "host_ms": _host_ms(kernel), "plain_ms": plain_ms,
                        "plain_device_ms": _device_ms(plain), "tops": _ops(kid, rows) / dev / 1e9,
                        **_compare(kernel(), plain())}
        def k6(x=x):
            return FL.layernorm_qkv(x, norm, *bf16, EPS)

        k6_ms, k8_ms = _ab_ms(k6, _calls(x, norm, q8)["K8"][0])
        codes = quantize_act(FL._layernorm_f32(x, norm, EPS))[0]
        row["K8 vs K6"] = {"K8_ms": k8_ms, "K6_ms": k6_ms, "K8_device_ms": row["K8"]["device_ms"],
                           "K6_device_ms": _device_ms(k6)}
        row["int_mm qkv"] = _device_ms(lambda: int8_matmul(codes, w_qkv))
        row["int_mm fc1"] = _device_ms(lambda: int8_matmul(codes, q8["fc1"]["w_q"]))
        k11 = _calls(x, norm, q8)["K11"][0]
        split_ms, k11_ms = _ab_ms(lambda x=x: _split_half(x, norm, q8), k11)
        row["K11 vs split"] = {"K11_ms": k11_ms, "split_ms": split_ms, "K11_device_ms": row["K11"]["device_ms"],
                               "split_device_ms": _device_ms(lambda x=x: _split_half(x, norm, q8)),
                               **_compare(k11(), _split_half(x, norm, q8))}
        results[f"bs{b} L{l}"] = row
        _log(f"bs{b} L{l} D{D} F{F}:")
        for kid in ("K8", "K9", "K10", "K11"):
            r = row[kid]
            _log(f"  {kid}: kernel {r['device_ms']:.4f} ms device ({r['tops']:.1f} TOP/s, "
                 f"{r['tops'] * 1e12 / PEAK_INT8:.3f} of the int8 peak), {r['ms']:.4f} ms by events through the "
                 f"wrapper, whose host time is {r['host_ms']:.4f} ms a call; plain {r['plain_device_ms']:.4f} ms device, {r['plain_ms']:.4f} by events; vs plain: "
                 f"equal {r['equal']:.6f}, max_abs_diff {r['max_abs_diff']:.4g}")
        k = row["K8 vs K6"]
        _log(f"  K8 {k['K8_device_ms']:.4f} ms device ({k8_ms:.4f} by events) against K6 (bf16, same x) "
             f"{k['K6_device_ms']:.4f} ms device ({k6_ms:.4f} by events); torch._int_mm alone (device): "
             f"{rows}x768 . 768x2304 {row['int_mm qkv']:.4f} ms "
             f"({_ops('K8', rows) / row['int_mm qkv'] / 1e9:.1f} TOP/s), 768x3072 {row['int_mm fc1']:.4f} ms "
             f"({_ops('K9', rows) / row['int_mm fc1'] / 1e9:.1f} TOP/s)")
        k = row["K11 vs split"]
        _log(f"  K11 {k['K11_device_ms']:.4f} ms device ({k['K11_ms']:.4f} by events) against the split MLP half "
             f"(K9 + dense_w8a8_pre) {k['split_device_ms']:.4f} ms device ({k['split_ms']:.4f} by events); "
             f"outputs equal {k['equal']:.6f}, largest difference {k['max_abs_diff']:.4g}")


def trace(results: dict) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    norm, q8, _ = _layer()
    x = _x(16, 1370)
    for kid, (kernel, _) in _calls(x, norm, q8).items():
        for _ in range(2):
            kernel()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kernel()
            torch.cuda.synchronize()
        _log(f"{kid} bs16 L1370, device time per call by kernel (torch.profiler, 5 calls):")
        for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total):
            results[f"trace {kid} {e.key[:60]}"] = e.self_device_time_total / 5e3
            _log(f"  {e.self_device_time_total / 5e3:.4f} ms  {e.key[:100]}")


def _entry_call(kid: str, fn, x, norm, q8, scratch: bool = True):
    """A call of the C entry ``fn`` of kernel ``kid`` on this layer, returning
    its outputs; ``scratch``: the entry takes the pre-pass's scratch (this
    tree's interface; the parent's K11 takes none)."""
    rows = x.numel() // D

    def ptrs(*ts):
        return [t.data_ptr() for t in ts]

    def run():
        held = FL._quant_scratch(x) if scratch else ()  # alive until the launch is queued
        extra = ptrs(*held)
        if kid == "K8":
            qkv = [q8[n] for n in "qkv"]
            res = [torch.empty_like(x) for _ in range(3)]
            err = fn(*ptrs(x, norm["scale"], norm["bias"], *(p["w_q"] for p in qkv), *(p["w_s"] for p in qkv),
                           *(p["b"] for p in qkv), *res), *extra, rows, D, EPS, _stream())
        elif kid == "K9":
            res = (torch.empty(*x.shape[:-1], F, dtype=torch.int8, device=x.device),
                   torch.empty(*x.shape[:-1], 1, device=x.device))
            fc1 = q8["fc1"]
            err = fn(*ptrs(x, norm["scale"], norm["bias"], fc1["w_q"], fc1["w_s"], fc1["b"], *res), *extra, rows, D,
                     F, EPS, _stream())
        elif kid == "K11":
            res = torch.empty_like(x)
            fc1, fc2 = q8["fc1"], q8["fc2"]
            err = fn(*ptrs(x, norm["scale"], norm["bias"], fc1["w_q"], fc1["w_s"], fc1["b"], fc2["w_q"], fc2["w_s"],
                           fc2["b"], res), *extra, rows, D, F, EPS, _stream())
        else:
            res = torch.empty_like(x)
            p = q8["out"]
            err = fn(*ptrs(x, p["w_q"], p["w_s"], p["b"], res), *extra, rows, D, D, _stream())
        _build.check_cuda(err, kid)
        return res

    return run


_ENTRY = {"K8": "ucod_layernorm_qkv_w8a8", "K9": "ucod_layernorm_fc1_gelu_w8a8", "K10": "ucod_quant_dense_w8a8",
          "K11": "ucod_layernorm_mlp_w8a8"}


def _ab(base, other) -> dict:
    """``base`` (this tree's kernel) against ``other``, both through the C
    entries: events interleaved, then device times."""
    base_ms, ms = _ab_ms(base, other)
    return {"ms": ms, "this_ms": base_ms, "device_ms": _device_ms(other), "this_device_ms": _device_ms(base),
            "host_ms": _host_ms(other), "this_host_ms": _host_ms(base), **_compare(other(), base())}


def parent_ab(parent: Path, results: dict) -> None:
    lib = _parent_lib(parent)
    kernels = _build.kernels()
    norm, q8, _ = _layer()
    _log(f"parent {parent} against this tree (interleaved this, parent, parent, this; both through their C entries):")
    for b, l in SHAPES + ((8, 1370), (1, 1370)):
        x = _x(b, l)
        for kid in ("K8", "K9", "K10", "K11"):
            r = _ab(_entry_call(kid, getattr(kernels, _ENTRY[kid]), x, norm, q8),
                    _entry_call(kid, getattr(lib, _ENTRY[kid]), x, norm, q8, scratch=kid != "K11"))
            results[f"parent {kid} bs{b} L{l}"] = r
            _log(f"  bs{b} L{l} {kid}: by events parent {r['ms']:.4f} ms, this {r['this_ms']:.4f} "
                 f"({r['ms'] / r['this_ms']:.3f}x); device parent {r['device_ms']:.4f} ms, this "
                 f"{r['this_device_ms']:.4f} ({r['device_ms'] / r['this_device_ms']:.3f}x); host per call parent "
                 f"{r['host_ms']:.4f} ms, this {r['this_host_ms']:.4f}; outputs equal {r['equal']:.6f}, largest difference {r['max_abs_diff']:.4g}")


# name -> (source file, what it changes, edit); the kernels each one is timed on in VARIANT_KERNELS
VARIANTS = {
    "k11_local_codes": ("int8_linear.cu", "diagnostic: K11's fc2 A fragments from the CTA's own codes (no "
                        "distributed shared memory traffic)",
                        _sub("ucod::map_shared_cluster(sm.codes + row_off + ((col + 16 * tq) ^ xr), q);",
                             "ucod::map_shared_cluster(sm.codes + row_off + ((col + 16 * tq) ^ xr), rank + 0 * q);")),
    "k11_w2_one_box": ("int8_linear.cu", "K11's all-gather streams W2 in stages of one 128-byte K box a consumer, "
                       "not two", _sub("kN2 * kBlockK ? 2 : 1;", "kN2 * kBlockK ? 1 : 1;")),
    "k11_no_fc2_loads": ("int8_linear.cu", "diagnostic: K11's fc2 A fragments loaded once a tile, not per stage",
                         _sub("        if (kt + 1 < kTiles2) load(nxt, kt + 1);\n", "")),
    "k9_grid": ("int8_linear.cu", "K9 and K11: one row tile per cluster (not persistent)",
                _sub("const int n_clusters = args.n_tiles < max_clusters ? args.n_tiles : max_clusters;",
                     "const int n_clusters = args.n_tiles;")),
    "stages2": ("int8_linear.cu", "two-stage rings",
                _sub("constexpr int kStages = 3;", "constexpr int kStages = 2;")),
    "k8_grid": ("int8_linear.cu", "K8/K10: one CTA per work tile (not persistent)",
                _sub("n_work < n_sm ? n_work : n_sm", "n_work")),
    "k8_no_store": ("int8_linear.cu", "diagnostic: K8/K10 outputs staged but not stored",
                    _sub("for (int a = 0; a < kBlockN / 64; ++a) ucod::tma_store_3d(tm_o, sm.out[c][a], n0 + 64 * a, m0, 0);",
                         "(void)tm_o;")),
    "k9_no_gelu": ("int8_linear.cu", "diagnostic: K9 and K11 without the tanh GELU (g = h1)",
                   _sub("= gelu_tanh(rescale(", "= (rescale(")),
    "k9_no_exchange": ("int8_linear.cu", "diagnostic: K9's and K11's row maxima from their own CTA only, no "
                       "cluster exchange",
                       _chain(_sub("    if (ct < kCluster) ucod::mbar_arrive_cluster(&sm.maxima[j & 1], ct);\n", ""),
                              _sub("      ucod::mbar_wait_cluster(&sm.maxima[j & 1], (j >> 1) & 1);\n", ""),
                              _sub("ucod::ld_shared_cluster_f32(&part[0][ct], q)", "part[0][ct]"),
                              _sub("ucod::ld_shared_cluster_f32(&part[1][ct], q)", "part[1][ct]"))),
    "k9_no_store": ("int8_linear.cu", "diagnostic: K9's codes staged but not stored",
                    _sub("      ucod::tma_store_3d(&tm_o, stage, col0 + c * kN, m0, 0);\n", "")),
}
VARIANT_KERNELS = {"k11_local_codes": ("K11",), "k11_no_fc2_loads": ("K11",),
                   "k11_w2_one_box": ("K11",), "k9_grid": ("K9", "K11"), "stages2": ("K8", "K9", "K11"),
                   "k8_grid": ("K8", "K10"), "k8_no_store": ("K8",), "k9_no_gelu": ("K9", "K11"),
                   "k9_no_exchange": ("K9", "K11"), "k9_no_store": ("K9",)}


def variants(results: dict, names=None) -> None:
    names = names or list(VARIANTS)
    lib = build_variants(names, VARIANTS, ENTRIES, "int8_variants")
    kernels = _build.kernels()
    _log("variants of this tree's int8 kernels (interleaved this, variant, variant, this; both through their "
         "C entries):")
    norm, q8, _ = _layer()
    for b, l in SHAPES:
        x = _x(b, l)
        for name in names:
            for kid in VARIANT_KERNELS[name]:
                fn = getattr(lib, f"{_ENTRY[kid]}_{name}")
                fn.argtypes = getattr(kernels, _ENTRY[kid]).argtypes
                fn.restype = ctypes.c_int
                r = _ab(_entry_call(kid, getattr(kernels, _ENTRY[kid]), x, norm, q8),
                        _entry_call(kid, fn, x, norm, q8))
                _log(f"  bs{b} L{l} {kid} {name} ({VARIANTS[name][1]}): {r['device_ms']:.4f} ms device "
                     f"({r['ms']:.4f} by events, host {r['host_ms']:.4f} a call) against {r['this_device_ms']:.4f} "
                     f"({r['this_ms']:.4f}, host {r['this_host_ms']:.4f}); equal {r['equal']:.6f}, largest "
                     f"difference {r['max_abs_diff']:.4g}")
                results[f"variant {name} {kid} bs{b} L{l}"] = r


def registers(results: dict) -> None:
    """Registers and spills of the int8 kernels, from ptxas -v in build.log,
    and any C7514 line (ptxas serialized a wgmma)."""
    text = (_build.build_dir() / "build.log").read_text()
    serialized = [line for line in text.splitlines() if "C7514" in line]
    results["ptxas C7514 lines"] = len(serialized)
    _log(f"ptxas C7514 (wgmma serialized) lines in build.log: {len(serialized)}")
    for line in serialized[:8]:
        _log(f"  {line}")
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?\n(.*?)\n(.*?Used (\d+) registers.*?)\n", text, re.S):
        name, spills, regs = m.group(1), m.group(2).strip(), m.group(4)
        kernel = re.search(r"((?:quant_gemm|mlp|quantize_rows)_kernel)(I(?:L[a-z]+\d+E)+E)?", name)
        if kernel:
            label = kernel.group(1) + (kernel.group(2) or "")
            results[f"ptxas {label}"] = {"registers": int(regs), "spills": spills}
            _log(f"ptxas {label}: {regs} registers; {spills}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of the parent tree to time against")
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS), metavar="NAME",
                        help="time the source variants in VARIANTS (all of them when no NAME is given)")
    parser.add_argument("--sass", action="store_true", help="count instructions in int8_linear.o's SASS")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": smi}
    if args.sass:
        sass_counts(results, sources=("int8_linear",), ops=("IGMMA", "UTMALDG", "UTMASTG", "IMMA"))
        registers(results)
    info(results)
    kernels_vs_plain(results)
    trace(results)
    if args.parent is not None:
        parent_ab(args.parent, results)
    if args.variants is not None:
        variants(results, args.variants)
    _log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
