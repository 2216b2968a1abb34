"""Same-process timing of K13 (the patch embed as one im2col GEMM) on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.patch_embed_ab [--variants [NAME ...]]

It answers on the card what the TPU prototypes
``scripts/microbench/bench_patch_embed.py`` (the patch embed as a matmul
against the convolution) and ``bench_patch_embed3.py`` (one im2col matmul
with the bias and the position rows fused) asked.  Prints the card's name
and power limit (nvidia-smi), then at bs16 518px (serving), bs16 224px
(pseudo-labels) and bs4 756px (CORAL's m-patches), f32 NHWC pixels, D 768,
bf16, with the position rows: K13 against each of
  * ``conv``: ``models/dino.py::_embed``'s path, a cuDNN convolution on the
    permuted bf16 pixels, flatten/transpose, the bias and position adds
    (what the card runs today);
  * ``conv14x1``: the JAX package's adopted form, a (14, 1)-kernel
    convolution on the free (W/14, 14 * 3) reshape of the pixels;
  * ``matmul``: an im2col copy, one cuBLAS product, the bias and position
    adds;
  * ``plain``: K13's plain version;
interleaved, by CUDA events and by the card's own time
(``attention_ab._device_ms``), with each one's largest difference from the
plain version; and beside them one ``F.conv2d`` call with its bias on
pixels already in bf16 (``library``: a yardstick without the cast and the
position add).

* ``--variants [NAME ...]``: edits of ``csrc/patch_embed.cu``
  (``VARIANTS``, all or those named), built into
  ``build/ucod_dpl_tpu_torch/patch_embed_variants/`` and timed interleaved
  against this tree's K13 at the same shapes; the variants marked
  "diagnostic" compute a wrong result on purpose: they show what one part
  costs.

Exits 1 without a CUDA device.  Times are CUDA-event means over 20 calls
after 3 warm-ups, each the mean of its two interleaved runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops import _build
from ucod_dpl_tpu_torch.ops.patch_embed import PATCH, im2col, patch_embed, patch_embed_reference, pqc_weight
from ucod_dpl_tpu_torch.tools.attention_ab import (
    _ab_ms,
    _chain,
    _device_ms,
    _log,
    _stream,
    _sub,
    _time_ms,
    build_variants,
)

D = 768
SHAPES = ((16, 518), (16, 224), (4, 756))


def _inputs(b: int, size: int, seed: int = 0):
    """f32 pixels, the f32 (D, 3, 14, 14) convolution kernel, f32 bias and
    bf16 position rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    px = torch.randn(b, size, size, 3, generator=g, device="cuda")
    kernel = 0.02 * torch.randn(D, 3, PATCH, PATCH, generator=g, device="cuda")
    bias = 0.1 * torch.randn(D, generator=g, device="cuda")
    pos = (0.1 * torch.randn((size // PATCH) ** 2, D, generator=g, device="cuda")).to(torch.bfloat16)
    return px, kernel, bias, pos


def paths(px, kernel, bias, pos) -> dict:
    """name -> a call computing the patch tokens + bias + position rows."""
    bf16 = torch.bfloat16
    b, h, w, _ = px.shape
    w_pqc = pqc_weight(kernel).to(bf16).contiguous()
    k_bf16, b_bf16 = kernel.to(bf16), bias.to(bf16)
    # (D, 3, p, q) -> (D, q * 3 + c, p, 1): the kernel of the (14, 1) conv
    k_14x1 = k_bf16.permute(0, 3, 1, 2).reshape(D, 3 * PATCH, PATCH, 1)

    def conv():
        y = F.conv2d(px.to(bf16).permute(0, 3, 1, 2), k_bf16, stride=PATCH)
        return y.flatten(2).transpose(1, 2) + b_bf16 + pos

    def conv14x1():
        x = px.to(bf16).reshape(b, h, w // PATCH, 3 * PATCH).permute(0, 3, 1, 2)
        return F.conv2d(x, k_14x1, stride=(PATCH, 1)).flatten(2).transpose(1, 2) + b_bf16 + pos

    def matmul():
        return torch.matmul(im2col(px.to(bf16), PATCH), w_pqc) + b_bf16 + pos

    return {"K13": lambda: patch_embed(px, w_pqc, bias, pos), "conv": conv, "conv14x1": conv14x1,
            "matmul": matmul, "plain": lambda: patch_embed_reference(px, w_pqc, bias, pos)}


def embed_vs_others(results: dict) -> None:
    for b, size in SHAPES:
        px, kernel, bias, pos = _inputs(b, size)
        calls = paths(px, kernel, bias, pos)
        ref = calls["plain"]().float()
        px_bf16 = px.to(torch.bfloat16).permute(0, 3, 1, 2)
        k_bf16, b_bf16 = kernel.to(torch.bfloat16), bias.to(torch.bfloat16)
        row = {"K13_device": _device_ms(calls["K13"]),
               "library": _time_ms(lambda: F.conv2d(px_bf16, k_bf16, b_bf16, stride=PATCH)),
               "max_abs_plain": ref.abs().max().item()}
        k13_runs = []
        for name in ("conv", "conv14x1", "matmul", "plain"):
            ms, k13_ms = _ab_ms(calls[name], calls["K13"])
            k13_runs.append(k13_ms)
            row[name] = ms
            row[f"{name}_device"] = _device_ms(calls[name])
            row[f"{name}_max_abs_diff"] = (calls[name]().float() - ref).abs().max().item()
        row["K13"] = sum(k13_runs) / len(k13_runs)
        row["K13_max_abs_diff"] = (calls["K13"]().float() - ref).abs().max().item()
        row["K13_gbps"] = (px.numel() * 4 + (ref.numel() + pos.numel() + 588 * D) * 2) / row["K13_device"] / 1e6
        results[f"bs{b} {size}px"] = row
        _log(f"bs{b} {size}px D{D}: K13 {row['K13_device']:.4f} ms device ({row['K13_gbps']:.0f} GB/s), "
             f"{row['K13']:.4f} by events, max_abs_diff {row['K13_max_abs_diff']:.4g} (max |plain| "
             f"{row['max_abs_plain']:.4g}); "
             + "; ".join(f"{n} {row[n + '_device']:.4f} ms device ({row[n]:.4f} by events, max_abs_diff "
                         f"{row[n + '_max_abs_diff']:.4g})" for n in ("conv", "conv14x1", "matmul", "plain"))
             + f"; one F.conv2d with bias on bf16 pixels {row['library']:.4f} ms")


# name -> (source file, what it changes, edit)
VARIANTS = {
    "n128": ("patch_embed.cu", "128-column work tiles (wgmma m64n128k16; the pixels gathered six times)",
             _sub("constexpr int kBlockN = 256;", "constexpr int kBlockN = 128;")),
    "stages2": ("patch_embed.cu", "a two-stage W ring", _sub("constexpr int kStages = 3;", "constexpr int kStages = 2;")),
    "grid": ("patch_embed.cu", "one CTA per work tile (not persistent)",
             _sub("n_work < n_sm ? n_work : n_sm", "n_work")),
    "no_gather": ("patch_embed.cu", "diagnostic: no pixel loads (A = 0)",
                  _chain(_sub("raw[2 * h] = *reinterpret_cast<const float2*>(base0 + off);",
                              "raw[2 * h] = make_float2(0.f, 0.f);"),
                         _sub("raw[2 * h + 1] = *reinterpret_cast<const float2*>(base1 + off);",
                              "raw[2 * h + 1] = make_float2(0.f, 0.f);"))),
    "no_store": ("patch_embed.cu", "diagnostic: the outputs staged but not stored",
                 _sub("for (int b = 0; b < kBlockN / 64; ++b) ucod::tma_store_3d(&tm_o, sm.out[c][b], n0 + 64 * b, m0, 0);",
                      "(void)tm_o;")),
}


def variants(results: dict, names=None) -> None:
    names = list(names or VARIANTS)
    lib = build_variants(names, VARIANTS, ("ucod_patch_embed",), "patch_embed_variants")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _log("variants of this tree's K13 (interleaved this, variant, variant, this):")
    for b, size in SHAPES:
        px, kernel, bias, pos = _inputs(b, size)
        w_pqc = pqc_weight(kernel).to(torch.bfloat16).contiguous()
        ref = patch_embed(px, w_pqc, bias, pos)
        for name in names:
            fn = getattr(lib, f"ucod_patch_embed_{name}")
            fn.argtypes = [ptr] * 5 + [i32, i32, i32, i32, ptr]

            def run(fn=fn, name=name):
                out = torch.empty_like(ref)
                _build.check_cuda(fn(*(t.data_ptr() for t in (px, w_pqc, bias, pos, out)), b, size, size, D,
                                     _stream()), name)
                return out

            diff = (run().float() - ref.float()).abs().max().item()
            base_ms, ms = _ab_ms(lambda: patch_embed(px, w_pqc, bias, pos), run)
            dev_ms = (_device_ms(lambda: patch_embed(px, w_pqc, bias, pos)), _device_ms(run))
            _log(f"  bs{b} {size}px {name} ({VARIANTS[name][1]}): {dev_ms[1]:.4f} ms device ({ms:.4f} by events) "
                 f"against {dev_ms[0]:.4f} ms device ({base_ms:.4f}); largest difference {diff:.4g}")
            results[f"variant {name} bs{b} {size}px"] = {"ms": ms, "this_ms": base_ms, "device_ms": dev_ms[1],
                                                         "this_device_ms": dev_ms[0], "max_abs_diff": diff}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", nargs="*", choices=sorted(VARIANTS), default=None,
                        help="time the source variants in VARIANTS (all, or those named)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("patch_embed_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {"card": smi}
    embed_vs_others(results)
    if args.variants is not None:
        variants(results, args.variants)
    _log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
