"""Same-process timing of K12 (attention + out-projection + layerscale + residual) on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.attn_outproj_ab [--variants [NAME ...]]

It answers on the card what the TPU prototype
``scripts/microbench/bench_attn_outproj.py`` asked: is one kernel that
keeps the attention output on chip and applies the out-projection, its
bias, the layerscale and the residual add in its epilogue faster than the
composed path?  Prints the card's name and power limit (nvidia-smi), then
at bs16 L1370 (518px) and bs4 L2917 (756px), 12 heads of 64, D 768, bf16:
K12 against the path the port runs today (K1, then the ``F.linear``
out-projection and the bias, layerscale and residual adds in bf16 as
``models/dino.py`` applies them, with JAX's roundings), against K12's plain
version, and beside the cuBLAS out-projection alone (a yardstick: K12
computes more), interleaved, by CUDA events and by the card's own time
(``attention_ab._device_ms``); the largest differences from the plain
version and from the composed path; and a torch.profiler breakdown of the
composed path's kernels.

* ``--variants [NAME ...]``: edits of ``csrc/attn_outproj.cu``
  (``VARIANTS``, all or those named), built into
  ``build/ucod_dpl_tpu_torch/outproj_variants/`` and timed interleaved
  against this tree's K12 at the same shapes; the variants marked
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
from ucod_dpl_tpu_torch.ops import attention as A
from ucod_dpl_tpu_torch.ops.fused_layers import dense
from ucod_dpl_tpu_torch.tools.attention_ab import (
    _ab_ms,
    _device_ms,
    _drop_lines,
    _log,
    _stream,
    _sub,
    _time_ms,
    build_variants,
)

HEADS, D = 12, 768
SCALE = (D // HEADS) ** -0.5
SHAPES = ((16, 1370), (4, 2917))


def _inputs(b: int, l: int, seed: int = 0):
    """bf16 q, k, v and residual x, the bf16 (out, in) out-projection, f32
    bias and layerscale (the dtypes the serving backbone holds)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, x = (torch.randn(b, l, D, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    wo = (torch.randn(D, D, generator=g, device="cuda") / D ** 0.5).to(torch.bfloat16)
    bo = 0.1 * torch.randn(D, generator=g, device="cuda")
    ls = 1 + 0.1 * torch.randn(D, generator=g, device="cuda")
    return q, k, v, x, wo, bo, ls


def composed(q, k, v, x, wo, bo, ls):
    """The attention half of a layer as the port composes it without K12:
    K1, the out-projection rounded to bf16 before its bias, the layerscale
    and the residual in bf16 (models/dino.py)."""
    attn = dense(A.packed_attention(q, k, v, HEADS, SCALE), {"w": wo, "b": bo}, torch.bfloat16)
    return x + attn * ls.to(torch.bfloat16)


def fused_vs_composed(results: dict) -> None:
    for b, l in SHAPES:
        args = _inputs(b, l)
        q, k, v, _, wo = args[:5]

        def k12():
            return A.attention_outproj_residual(*args, HEADS, SCALE)

        def plain():
            return A.attention_outproj_residual_reference(*args, HEADS, SCALE)

        def comp():
            return composed(*args)

        attn = A.packed_attention(q, k, v, HEADS, SCALE)
        k12_ms, comp_ms = _ab_ms(k12, comp)
        plain_ms, k12_ms2 = _ab_ms(plain, k12)
        ref = plain().float()
        row = {"K12": (k12_ms + k12_ms2) / 2, "composed": comp_ms, "plain": plain_ms,
               "K1_alone": _time_ms(lambda: A.packed_attention(q, k, v, HEADS, SCALE)),
               "outproj_alone": _time_ms(lambda: F.linear(attn, wo)),
               "K12_device": _device_ms(k12), "composed_device": _device_ms(comp),
               "outproj_alone_device": _device_ms(lambda: F.linear(attn, wo)),
               "max_abs_diff_plain": (k12().float() - ref).abs().max().item(),
               "max_abs_diff_composed": (k12().float() - comp().float()).abs().max().item(),
               "max_abs_plain": ref.abs().max().item()}
        row["K12_tflops"] = (4.0 * b * HEADS * l * l * (D // HEADS) + 2.0 * b * l * D * D) / row["K12_device"] / 1e9
        results[f"bs{b} L{l}"] = row
        _log(f"bs{b} L{l} D{D}: K12 {row['K12_device']:.4f} ms device ({row['K12_tflops']:.1f} TFLOP/s), "
             f"{row['K12']:.4f} by events; composed (K1 + out-projection + bias, layerscale, residual) "
             f"{row['composed_device']:.4f} ms device ({comp_ms:.4f} by events; K1 alone {row['K1_alone']:.4f}); "
             f"cuBLAS out-projection alone {row['outproj_alone_device']:.4f} ms device; plain {plain_ms:.4f} ms; "
             f"K12 vs plain max_abs_diff {row['max_abs_diff_plain']:.4g}, vs composed "
             f"{row['max_abs_diff_composed']:.4g} (max |plain| {row['max_abs_plain']:.4g})")


def trace(results: dict) -> None:
    """The composed path's and K12's device time by kernel at bs16 L1370."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = _inputs(16, 1370)
    for name, fn in (("composed", lambda: composed(*args)),
                     ("K12", lambda: A.attention_outproj_residual(*args, HEADS, SCALE))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        _log(f"{name} bs16 L1370, device time per call by kernel (torch.profiler, 5 calls):")
        for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total):
            results[f"trace {name} {e.key[:60]}"] = e.self_device_time_total / 5e3
            _log(f"  {e.self_device_time_total / 5e3:.4f} ms  {e.key[:100]}")


# name -> (source file, what it changes, edit)
VARIANTS = {
    "no_outproj": ("attn_outproj.cu", "diagnostic: the attention alone, no out-projection, epilogue or Wo loads",
                   _sub("for (int p = 0; p < n_ntp; ++p) {", "for (int p = 0; p < 0; ++p) {")),
    "no_pingpong": ("attn_outproj.cu", "no turn-taking of the two consumer warpgroups",
                    _drop_lines(r"named_(sync|arrive)\(kSchedBar")),
    "no_exp": ("attn_outproj.cu", "diagnostic: P = s * scale - m, no ex2",
               _sub("s[i] = ucod::exp2_ftz(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));",
                    "s[i] = fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]);")),
}


def variants(results: dict, names=None) -> None:
    names = list(names or VARIANTS)
    lib = build_variants(names, VARIANTS, ("ucod_attention_outproj",), "outproj_variants")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _log("variants of this tree's K12 (interleaved this, variant, variant, this):")
    for b, l in SHAPES:
        args = _inputs(b, l)
        ref = A.attention_outproj_residual(*args, HEADS, SCALE)
        for name in names:
            fn = getattr(lib, f"ucod_attention_outproj_{name}")
            fn.argtypes = [ptr] * 8 + [i32, i32, i32, f32, ptr]

            def run(fn=fn, name=name):
                out = torch.empty_like(args[0])
                _build.check_cuda(fn(*(t.data_ptr() for t in (*args, out)), b, l, HEADS, SCALE * A._LOG2E,
                                     _stream()), name)
                return out

            diff = (run().float() - ref.float()).abs().max().item()
            base_ms, ms = _ab_ms(lambda: A.attention_outproj_residual(*args, HEADS, SCALE), run)
            _log(f"  bs{b} L{l} {name} ({VARIANTS[name][1]}): {ms:.4f} ms against {base_ms:.4f} ms; "
                 f"largest difference {diff:.4g}")
            results[f"variant {name} bs{b} L{l}"] = {"ms": ms, "this_ms": base_ms, "max_abs_diff": diff}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", nargs="*", choices=sorted(VARIANTS), default=None,
                        help="time the source variants in VARIANTS (all, or those named)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_outproj_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": smi}
    fused_vs_composed(results)
    trace(results)
    if args.variants is not None:
        variants(results, args.variants)
    _log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
