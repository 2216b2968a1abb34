"""Same-process timing of the port's attention kernels on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.attention_ab [--parent DIR] [--variants [NAME ...]] [--sass]

Always: the card's name and power limit (nvidia-smi), then the forward (K1),
the forward with log-sum-exp (K2) and the backward (K3/K4) at bs16 L1370 and
bs4 L2917 (D 768 bf16: 12 heads of 64 and 6 heads of 128), each beside
one ``scaled_dot_product_attention`` call on the same tensors (its backward for
the backward), the forward at K5's shapes (per-head (48, 1370, 64) and the
tensor-parallel shard's packed (16, 1370, 3 * 64)) beside SDPA, and a
torch.profiler breakdown of the backward's kernels at each head dim.

* ``--parent DIR``: DIR is a checkout of a parent tree whose attention
  C entries take this tree's arguments (``ucod_attention_fwd`` a head dim,
  ``ucod_attention_fwd_lse`` and ``ucod_attention_bwd`` a key bound and an
  f32-output flag; a head dim too, or no head dim, as before head dim 128,
  read from the parent's own ``_build`` declarations).  Its kernels are built from DIR by DIR's own
  ``ops/_build.py`` and timed against this tree's, interleaved parent,
  this, this, parent, at bs16 L1370 and bs4 L2917 and each head dim (128
  only where the parent's entries take a head dim); the outputs of the two
  are compared bit for bit (K1, K2's o and log-sum-exp, dq, dk, dv).
* ``--variants [NAME ...]``: variants of this tree's kernels (all, or those
  named), each an edit of its source (``VARIANTS``; the shared flash-loop
  header ``attention_common.cuh`` written into it, see ``variant_source``),
  built into ``build/ucod_dpl_tpu_torch/variants/`` and timed
  interleaved against the kernel it varies.  Variants marked "diagnostic"
  compute another function on purpose: they show what one part costs.
  The K1 variants that port the TPU attention prototypes
  (``PROTO_VARIANTS``, by prototype site in ``SITES``) are held against
  their plain functions (``plain_of``; K1's own where they compute K1's
  function) within 2^-6 of max|plain|, raising past it, and timed by the
  card's own time (``_device_ms``) against K1 at bs16 L1370 and bs4 L2917,
  the row variants also at bs8 L2917.  A structural variant is a
  ``Schedule`` of attention_fwd.cu of its own, instantiated by its entry
  in this build only.  The ``bwd128_`` variants edit the head-dim-128
  backward and run at head dim 128 (6 heads), the other backward variants
  at 64.
* ``--sass``: instruction counts in the SASS of the built attention objects
  (``cuobjdump -sass``), per object and per kernel instantiation: HGMMA
  (wgmma), UTMALDG (TMA loads), UBLKRED (bulk reduce-add), HMMA (mma.sync),
  MUFU.EX2; with ``--variants``, of the variants' objects too; with
  ``--parent``, whether each kernel's SASS is the parent's instruction for
  instruction (kernels paired by their mangled names); and each object's
  ptxas report from ``build.log`` (registers, spills, shared memory).

Exits 1 without a CUDA device.  Times are CUDA-event means over 20 calls
after 3 warm-ups, each the mean of its two interleaved runs.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops import _build
from ucod_dpl_tpu_torch.ops import attention as A

HEADS, SCALE = 12, 0.125  # head dim 64; at head dim hd: D_MODEL // hd heads, scale hd ** -0.5
D_MODEL = HEADS * 64
HEAD_DIMS = (64, 128)  # of the library timings, the traces and the parent A/B
SHAPES = ((16, 1370), (4, 2917))
SHAPE_756 = (8, 2917)  # bench_attention_756.py's shape: the row variants are also timed there
# A forward variant against its plain function: chip_smoke.py's K1 bound,
# 2^-6 of max|plain| (both round p and o to bf16; one ulp of the largest
# output apart on an H100)
TOL = 2.0 ** -6


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The card's time per call of ``fn``: CUDA events around ``iters``
    calls queued behind a sleep kernel long enough for the host to enqueue
    them all, so the card runs them back to back and the host's own time per
    call (checks, allocations, tensor maps) is not in the reading, as it is
    in :func:`_time_ms` when a call takes longer on the host than on the
    card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_s + 1e-3, 0.5) * 2e9))  # cycles at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ab_ms(a, b, timer=_time_ms):
    """Interleaved a, b, b, a -> (a ms, b ms), each the mean of its two runs."""
    a1, b1, b2, a2 = timer(a), timer(b), timer(b), timer(a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _hs(hd: int):
    """(heads, scale) at head dim ``hd`` over D_MODEL columns."""
    return D_MODEL // hd, hd ** -0.5


def _inputs(b: int, l: int, seed: int = 0, hd: int = 64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, l, D_MODEL, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, lse = A.packed_attention_fwd_lse(q, k, v, *_hs(hd))
    return q, k, v, do, o, lse


def _heads(x, hd: int = 64):
    b, l, d = x.shape
    return x.view(b, l, d // hd, hd).transpose(1, 2)


def library(results: dict) -> None:
    """This tree's kernels beside scaled_dot_product_attention."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(48, 1370, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    row = {"K5 per-head": _time_ms(lambda: A.heads_attention(q, k, v, SCALE)),
           "sdpa": _time_ms(lambda: F.scaled_dot_product_attention(*(x.unsqueeze(1) for x in (q, k, v)), scale=SCALE))}
    q, k, v = (x.view(16, 1370, 3 * 64) for x in (q, k, v))
    row["K5 TP shard packed"] = _time_ms(lambda: A.packed_attention(q, k, v, 3, SCALE))
    row["sdpa TP shard"] = _time_ms(lambda: F.scaled_dot_product_attention(
        *(x.view(16, 1370, 3, 64).transpose(1, 2) for x in (q, k, v)), scale=SCALE))
    results["K5 48 heads L1370 d64"] = row
    _log("K5 48 heads L1370 d64: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))


def library_at(results: dict, hd: int) -> None:
    """K1, K2 and the backward at head dim ``hd`` beside SDPA, its forward and
    its backward, on the same tensors; the backward's ratios to SDPA's
    backward and to its bound."""
    heads, scale = _hs(hd)
    tag = "" if hd == 64 else f" hd{hd}"
    for b, l in SHAPES:
        q, k, v, do, o, lse = _inputs(b, l, hd=hd)
        hq, hk, hv = (_heads(x, hd).detach().requires_grad_(True) for x in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(hq, hk, hv, scale=scale)
        row = {
            "K1": _time_ms(lambda: A.packed_attention(q, k, v, heads, scale)),
            "K2": _time_ms(lambda: A.packed_attention_fwd_lse(q, k, v, heads, scale)),
            "bwd": _time_ms(lambda: A.packed_attention_bwd(q, k, v, o, do, lse, heads, scale)),
            "sdpa_fwd": _time_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv, scale=scale)),
            "sdpa_bwd": _time_ms(lambda: torch.autograd.grad(o_sdpa, (hq, hk, hv), _heads(do, hd), retain_graph=True)),
        }
        # the five products of the backward (2 * B * H * L^2 * hd operations each) at 989 TFLOP/s bf16
        row["bwd_bound"] = 5 * 2 * b * heads * l * l * hd / 989e12 * 1e3
        results[f"bs{b} L{l}{tag}"] = row
        _log(f"bs{b} L{l}{tag}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
             + f"; backward / SDPA backward {row['bwd'] / row['sdpa_bwd']:.3f}, / bound "
               f"{row['bwd'] / row['bwd_bound']:.3f}")


def trace_backward(hd: int = 64) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    heads, scale = _hs(hd)
    q, k, v, do, o, lse = _inputs(16, 1370, hd=hd)
    for _ in range(2):
        A.packed_attention_bwd(q, k, v, o, do, lse, heads, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            A.packed_attention_bwd(q, k, v, o, do, lse, heads, scale)
        torch.cuda.synchronize()
    _log(f"backward bs16 L1370 head dim {hd}, device time per call by kernel (torch.profiler, 5 calls):")
    for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total):
        _log(f"  {e.self_device_time_total / 5e3:.4f} ms  {e.key[:100]}")


# ---- the parent's kernels ---------------------------------------------------

def _parent_build(parent: Path):
    """The parent checkout's own ``ops/_build.py`` module."""
    spec = importlib.util.spec_from_file_location("parent_build", parent / "ucod_dpl_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parent_lib(parent: Path):
    return _parent_build(parent).kernels()


def parent_ab(parent: Path, results: dict, head_dim: int = 64) -> None:
    """The parent's K1, K2 and backward (its C entries taking this tree's
    arguments; the key bound L, bf16 outputs) against this tree's at the
    same shapes and head dim: whether the outputs are equal bit for bit, and
    their times interleaved parent, this, this, parent."""
    lib = _parent_lib(parent)  # its own _build declares its entries' C signatures
    # the head dim, where the parent's forward-LSE and backward entries take one
    hd = (head_dim,) if len(lib.ucod_attention_fwd_lse.argtypes) == 13 else ()
    if not hd and head_dim != 64:
        _log(f"parent {parent}: its backward takes no head dim, so none but 64 (skipped {head_dim})")
        return
    HEADS, SCALE = _hs(head_dim)
    tag = "" if head_dim == 64 else f" hd{head_dim}"

    def fwd(q, k, v):
        o = torch.empty_like(q)
        b, l, _ = q.shape
        _build.check_cuda(lib.ucod_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, HEADS,
                                                 head_dim, SCALE * A._LOG2E, _stream()), "parent fwd")
        return o

    def fwd_lse(q, k, v):
        o = torch.empty_like(q)
        b, l, _ = q.shape
        lse = torch.empty(b, HEADS, l, device=q.device)
        _build.check_cuda(lib.ucod_attention_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                                     lse.data_ptr(), b, l, l, HEADS, *hd, SCALE * A._LOG2E, 0,
                                                     _stream()),
                          "parent fwd_lse")
        return o, lse

    def bwd(q, k, v, o, do, lse):
        grads = [torch.empty_like(q) for _ in range(3)]
        b, l, _ = q.shape
        stats, dq_acc = A.bwd_scratch(b, l, HEADS, q.device, head_dim)
        _build.check_cuda(lib.ucod_attention_bwd(*(x.data_ptr() for x in (q, k, v, o, do, lse, stats, dq_acc, *grads)),
                                                 b, l, l, HEADS, *hd, SCALE, 0, _stream()), "parent bwd")
        return grads

    _log(f"parent {parent} against this tree at head dim {head_dim} (interleaved parent, this, this, parent):")
    for b, l in SHAPES:
        q, k, v, do, o, lse = _inputs(b, l, hd=head_dim)
        old = (fwd(q, k, v), *fwd_lse(q, k, v), *bwd(q, k, v, o, do, lse))
        new = (A.packed_attention(q, k, v, HEADS, SCALE), *A.packed_attention_fwd_lse(q, k, v, HEADS, SCALE),
               *A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE))
        equal = {name: torch.equal(x, y) for name, x, y in zip(("K1", "K2 o", "K2 lse", "dq", "dk", "dv"), old, new)}
        row = {}
        for name, old_fn, new_fn in (
            ("K1", lambda: fwd(q, k, v), lambda: A.packed_attention(q, k, v, HEADS, SCALE)),
            ("K2", lambda: fwd_lse(q, k, v), lambda: A.packed_attention_fwd_lse(q, k, v, HEADS, SCALE)),
            ("bwd", lambda: bwd(q, k, v, o, do, lse), lambda: A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)),
        ):
            row[name] = _ab_ms(old_fn, new_fn)
            _log(f"  bs{b} L{l}{tag} {name}: parent {row[name][0]:.4f} ms, this {row[name][1]:.4f} ms "
                 f"({row[name][0] / row[name][1]:.3f}x)")
        _log(f"  bs{b} L{l}{tag} equal bit for bit, parent vs this: {equal}")
        results[f"parent bs{b} L{l}{tag}"] = {**row, "equal": equal}


# ---- variants of this tree's kernels -----------------------------------------

# headers a variant's edit may reach: inlined into the source it edits
_EDITABLE_HEADERS = ("attention_common.cuh",)


def variant_source(src_name: str) -> str:
    """The text of ``csrc/<src_name>`` with the headers in
    ``_EDITABLE_HEADERS`` written in place of their ``#include``, so that a
    variant's edit reaches the code they hold (K1's and K12's online
    softmax); the other headers stay included."""
    src = (_build.CSRC / src_name).read_text()
    for header in _EDITABLE_HEADERS:
        text = (_build.CSRC / header).read_text().replace("#pragma once\n", "")
        src = src.replace(f'#include "{header}"\n', text)
    return src


def _sub(old: str, new: str):
    def edit(src: str) -> str:
        if old not in src:
            raise RuntimeError(f"variant edit does not apply: {old[:60]!r}")
        return src.replace(old, new)
    return edit


def _drop_lines(pattern: str):
    def edit(src: str) -> str:
        out = "\n".join(line for line in src.splitlines() if not re.search(pattern, line)) + "\n"
        if out == src:
            raise RuntimeError(f"variant edit does not apply: {pattern}")
        return out
    return edit


def _sub_span(start: str, end: str, new: str):
    """Replace the text from ``start`` up to (not including) ``end`` by ``new``."""
    def edit(src: str) -> str:
        i = src.find(start)
        j = src.find(end, i + 1) if i >= 0 else -1
        if j < 0:
            raise RuntimeError(f"variant edit does not apply: {start[:60]!r} .. {end[:60]!r}")
        return src[:i] + new + src[j:]
    return edit


def _chain(*edits):
    def edit(src: str) -> str:
        for e in edits:
            src = e(src)
        return src
    return edit


_NO_EXCHANGE_WRITE = """      {
        const int row = 16 * warp + g;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          float* half = out + (jb / 4) * 64 * 32;
          const int col = 8 * (jb % 4) + 2 * tq;
          *reinterpret_cast<float2*>(half + dq_half_offset<kHeadDim>(row, col)) = make_float2(dq[4 * jb], dq[4 * jb + 1]);
          *reinterpret_cast<float2*>(half + dq_half_offset<kHeadDim>(row + 8, col)) = make_float2(dq[4 * jb + 2], dq[4 * jb + 3]);
        }
      }"""
_EXCHANGE = """      if (c == 0) {
        dq_exchange_add<0>(dq, sm.xchg[i & 1], sm.xchg_full, i & 1, tid, out);
      } else {
        dq_exchange_add<1>(dq, sm.xchg[i & 1], sm.xchg_full, i & 1, tid, out);
      }"""
_BULK = "ucod::bulk_reduce_add_f32(dq_head + dst, sm.dq_out[c][i & 1], 32 * 64 * 4);"

# name -> (source file, what it changes, edit)
VARIANTS = {
    "fwd_grid": ("attention_fwd.cu", "one CTA per work tile (not persistent)",
                 _sub("n_units < n_sm ? n_units : n_sm", "n_work")),
    "fwd_stages2": ("attention_fwd.cu", "a two-stage K/V ring",
                    _sub("constexpr int kStages = 3;", "constexpr int kStages = 2;")),
    "fwd_no_pingpong": ("attention_fwd.cu", "no turn-taking of the two consumer warpgroups",
                        _drop_lines(r"named_(sync|arrive)\(kSchedBar")),
    "fwd_no_exp": ("attention_fwd.cu", "diagnostic: P = s * scale - m, no ex2",
                   _sub("s[i] = ucod::exp2_ftz(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));",
                        "s[i] = fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]);")),
    "bwd_stages2": ("attention_bwd.cu", "a two-stage Q/dO ring",
                    _sub("constexpr int kStages = 3;", "constexpr int kStages = 2;")),
    "bwd_atomics": ("attention_bwd.cu", "dQ halves added by per-thread float2 atomics, not an ordered bulk "
                                        "reduce-add (dq not deterministic)",
                    _chain(_sub("      float* out = sm.dq_out[c][i & 1];",
                                "      float* out = dq_acc + ((int64_t)bh * n_q + (q_first + i) % n_q) * 64 * kHeadDim"
                                " + c * 32 * 64;"),
                           _sub("    *reinterpret_cast<float2*>(out + dq_half_offset<kHeadDim>(row, col)) = make_float2(",
                                "    atomicAdd(reinterpret_cast<float2*>(out + dq_half_offset<kHeadDim>(row, col)), make_float2("),
                           _sub("    *reinterpret_cast<float2*>(out + dq_half_offset<kHeadDim>(row + 8, col)) = make_float2(",
                                "    atomicAdd(reinterpret_cast<float2*>(out + dq_half_offset<kHeadDim>(row + 8, col)), make_float2("),
                           _sub("make_float2(dq[4 * jb], dq[4 * jb + 1]);\n    atomicAdd",
                                "make_float2(dq[4 * jb], dq[4 * jb + 1]));\n    atomicAdd"),
                           _sub("make_float2(dq[4 * jb + 2], dq[4 * jb + 3]);\n  }\n}",
                                "make_float2(dq[4 * jb + 2], dq[4 * jb + 3]));\n  }\n}"),
                           _sub(_BULK, "(void)0;"))),
    "bwd_no_exchange": ("attention_bwd.cu", "each warpgroup adds its whole 64 x 64 dQ partial (16 KB), no "
                                            "exchange (the two warpgroups' adds unordered: dq not deterministic)",
                        _chain(_sub("float dq_out[kConsumers][2][64 * 32];", "float dq_out[kConsumers][2][64 * 64];"),
                               _sub(_EXCHANGE, _NO_EXCHANGE_WRITE),
                               _sub(_BULK, "ucod::bulk_reduce_add_f32(dq_head + dst - c * 32 * 64, sm.dq_out[c][i & 1], "
                                           "64 * 64 * 4);"))),
    "bwd_unordered": ("attention_bwd.cu", "dQ halves added in arrival order, no semaphore wait or release (dq not "
                                          "deterministic): what the ordering costs",
                      _drop_lines(r"ld_acquire_gpu|st_release_gpu")),
    "bwd_no_dq_add": ("attention_bwd.cu", "diagnostic: no dQ reduce-add", _sub(_BULK, "(void)0;")),
    "bwd_no_exp": ("attention_bwd.cu", "diagnostic: P = s * scale - lse, no ex2",
                   _sub("s[e] = ucod::exp2_ftz(fmaf(s[e], scale_log2, -stat[8 * (e >> 2) + 2 * tq + (e & 1)].x));",
                        "s[e] = fmaf(s[e], scale_log2, -stat[8 * (e >> 2) + 2 * tq + (e & 1)].x);")),
    "bwd_no_dq_product": ("attention_bwd.cu", "diagnostic: no dQ = dS K product",
                          _sub("ucod::wgmma_m64n64k16_ss<1, 1>(dq, ucod::desc_mnmajor(ds, kk), ucod::desc_mnmajor(k_c, kk), kk);",
                               "dq[kk] = 0.f;")),
    "bwd_no_dkdv": ("attention_bwd.cu", "diagnostic: no dV and dK products",
                    _chain(_sub("ucod::wgmma_m64n64k16_rs<1>(dv_acc, pa[kk], ucod::desc_mnmajor(sm.d_o[st], kk), 1);",
                                "dv_acc[kk] += __uint_as_float(pa[kk][0]);"),
                           _sub("ucod::wgmma_m64n64k16_rs<1>(dk_acc, da[kk], ucod::desc_mnmajor(sm.q[st], kk), 1);",
                                "dk_acc[kk] += __uint_as_float(da[kk][0]);"))),
    # the head-dim-128 backward (attention_bwd_d128_kernel), run at head dim 128
    "bwd128_stages3_dqbufs1": ("attention_bwd.cu", "three Q/dO stages and one dQ staging buffer a half (two stages "
                                                   "and double-buffered staging in this tree)",
                               _chain(_sub("constexpr int kStages128 = 2;", "constexpr int kStages128 = 3;"),
                                      _sub("constexpr int kDqBufs128 = 2;", "constexpr int kDqBufs128 = 1;"))),
    "bwd128_no_overlap": ("attention_bwd.cu", "step i + 1's S^T issued after step i - 1's dQ is staged, not behind "
                                              "its dQ product",
                          _chain(_sub("      if constexpr (!decltype(last)::value) issue_s(i + 1);\n", ""),
                                 _sub("ucod::wgmma_wait<1>();  // dQ; S^T of step i + 1 in flight",
                                      "ucod::wgmma_wait<0>();"),
                                 _sub("        ucod::wgmma_wait<0>();\n        ucod::fence_regs(s);\n      }\n",
                                      "        issue_s(i + 1);\n        ucod::wgmma_wait<0>();\n"
                                      "        ucod::fence_regs(s);\n      }\n"))),
    "bwd128_lockstep": ("attention_bwd.cu", "each step's own dQ in the step, after both warpgroups' dS^T (the two "
                                            "warpgroups in lock step), not one step late",
                        _chain(_sub("      if constexpr (!decltype(first)::value) {\n        issue_dq(i - 1);",
                                    "      if constexpr (true) {\n        issue_dq(i);"),
                               _sub("      if constexpr (!decltype(first)::value) {\n"
                                    "        if constexpr (decltype(last)::value) {",
                                    "      if constexpr (true) {\n        if constexpr (decltype(last)::value) {"),
                               _sub("        stage_dq(i - 1);", "        stage_dq(i);"),
                               _sub("    issue_dq(n_q - 1);\n    ucod::wgmma_wait<0>();\n    stage_dq(n_q - 1);\n", ""))),
    "bwd128_dp_ahead": ("attention_bwd.cu", "step i + 1's dP^T issued beside its S^T, behind step i's dQ "
                                            "(224 accumulator registers live)",
                        _chain(_sub("      issue_dp(i);\n", ""),
                               _sub("      ucod::wgmma_wait<1>();  // dP^T; dV in flight\n      ucod::fence_regs(dp);\n", ""),
                               _sub("issue_s(i + 1);", "{\n        issue_s(i + 1);\n        issue_dp(i + 1);\n      }"),
                               _sub("ucod::wgmma_wait<1>();  // dQ; S^T of step i + 1 in flight",
                                    "ucod::wgmma_wait<2>();  // dQ; S^T and dP^T of step i + 1 in flight"),
                               _sub("        ucod::fence_regs(s);\n      }\n    };\n",
                                    "        ucod::fence_regs(s);\n        ucod::fence_regs(dp);\n      }\n    };\n"),
                               _sub("    issue_s(0);\n    ucod::wgmma_wait<0>();\n    ucod::fence_regs(s);\n",
                                    "    issue_s(0);\n    issue_dp(0);\n    ucod::wgmma_wait<0>();\n"
                                    "    ucod::fence_regs(s);\n    ucod::fence_regs(dp);\n"))),
    "bwd128_dq_free_late": ("attention_bwd.cu", "a dQ staging buffer freed once its addition has completed, not "
                                                "once the addition has read it",
                            _sub_span("ucod::mbar_arrive(&sm.dq_free[c][buf]);  // the staging buffer is read",
                                      "\n      }\n    }\n  } else {",
                                      "ucod::bulk_wait<0>();\n        ucod::fence_proxy_async_global();\n"
                                      "        ucod::st_release_gpu(sem_h + 2 * tile, rank + 1);\n"
                                      "        ucod::mbar_arrive(&sm.dq_free[c][buf]);")),
    "bwd128_no_exp": ("attention_bwd.cu", "diagnostic: P = s * scale - lse, no ex2, at head dim 128",
                      _sub("s[e] = ucod::exp2_ftz(fmaf(s[e], scale_log2, -stat[8 * (e >> 2) + 2 * tq + (e & 1)].x));",
                           "s[e] = fmaf(s[e], scale_log2, -stat[8 * (e >> 2) + 2 * tq + (e & 1)].x);")),
    "bwd128_no_dq_product": ("attention_bwd.cu", "diagnostic: no dQ = dS K product at head dim 128",
                             _sub("ucod::wgmma_m64n64k16_ss<1, 1>(dq, ucod::desc_mnmajor(sm.ds[j & 1], kk), "
                                  "ucod::desc_mnmajor(k_half, kk), kk);", "dq[kk] = 0.f;")),
    "bwd128_no_ds_wait": ("attention_bwd.cu", "diagnostic: a dQ product does not wait for the other warpgroup's "
                                              "dS^T (dq wrong)",
                          _drop_lines(r"mbar_wait\(&sm\.ds_full")),
    "bwd128_no_dkdv": ("attention_bwd.cu", "diagnostic: no dV and dK products at head dim 128",
                       _chain(_sub("ucod::wgmma_m64n64k16_rs<1>(dv_acc[a], pa[kk], ucod::desc_mnmajor(do_st + a * "
                                   "kBlockQ * kAtom, kk), 1);", "dv_acc[a][kk] += __uint_as_float(pa[kk][0]);"),
                              _sub("ucod::wgmma_m64n64k16_rs<1>(dk_acc[a], da[kk], ucod::desc_mnmajor(q_st + a * "
                                   "kBlockQ * kAtom, kk), 1);", "dk_acc[a][kk] += __uint_as_float(da[kk][0]);"))),
    "bwd128_unordered": ("attention_bwd.cu", "dQ halves added in arrival order, no semaphore wait or release (dq not "
                                             "deterministic): what the ordering costs at head dim 128",
                         _drop_lines(r"ld_acquire_gpu|st_release_gpu")),
    "bwd128_no_dq_add": ("attention_bwd.cu", "diagnostic: no dQ reduce-add at head dim 128",
                         _chain(_sub("          ucod::bulk_store(dq_head + dst, sm.dq[c][buf], 64 * kAtom * 4);",
                                     "          (void)0;"),
                                _sub("          ucod::bulk_reduce_add_f32(dq_head + dst, sm.dq[c][buf], 64 * kAtom * 4);",
                                     "          (void)0;"))),
}

# ---- K1 variants that port the TPU attention prototypes ----------------------


def _schedule(struct: str, member: str):
    """A structural variant of K1: ``struct``, a ``Schedule`` of
    attention_fwd.cu with ``member`` changed, defined before the C entries
    and launched by the forward entry at head dim 64."""
    return _chain(
        _sub('\nextern "C" int ucod_attention_fwd(const',
             f'\nnamespace {{\nstruct {struct} : Schedule {{\n  {member}\n}};\n}}  // namespace\n\n'
             'extern "C" int ucod_attention_fwd(const'),
        _sub("return launch<64, false>(q, k, v, o, nullptr,", f"return launch<64, false, bf16, {struct}>(q, k, v, o, nullptr,"))


_MASK = "  if (k0 + kBlockK > kv_len) {\n"
_SOFTMAX_START = "int tq, float scale_log2) {\n"
_ROW_MAX = "  float mx[2] = {-INFINITY, -INFINITY};\n"
_EXP = "#pragma unroll\n  for (int i = 0; i < kBlockK / 2; ++i) {\n    s[i] = ucod::exp2_ftz("
_P_EXP = "s[i] = ucod::exp2_ftz(fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]));"
_SUM = "    l[(i >> 1) & 1] += s[i];\n"
# fwd_scale_q: each consumer warpgroup scales its Q rows in shared memory as
# they arrive, as the prototype's kernel scales each q block in its body
_SCALE_Q = """      {  // this warpgroup's Q rows <- bf16(q * scale_log2), in place, before its first S product
#pragma unroll
        for (int a = 0; a < H::kAtoms; ++a) {
          uint4* rows = reinterpret_cast<uint4*>(const_cast<bf16*>(q_tile) + a * kBlockQ * H::kAtomCols);
          for (int i = tid; i < 64 * H::kAtomCols / 8; i += 128) {  // 8 bf16 a vector; the swizzle does not matter
            uint4 x = rows[i];
            __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(h2[e]);
              h2[e] = __floats2bfloat162_rn(f.x * scale_log2, f.y * scale_log2);
            }
            rows[i] = x;
          }
        }
        ucod::fence_proxy_async();  // before the S products (async proxy) read them
        ucod::named_sync(T::kOutBar + c, 128);
      }
"""
_Q_FULL = "      ucod::mbar_wait(&sm.q_full, n & 1);\n"
SHIFT = 30.0  # log2 units: the JAX production kernel's _SOFTMAX_SHIFT
# the row max, its shuffles and O's rescale give way to a constant shift
_SHIFT = _chain(
    _sub_span(_ROW_MAX, _EXP, f"  const float mu[2] = {{{SHIFT:.1f}f, {SHIFT:.1f}f}};  // a constant shift, log2 units\n"
                              f"  m[0] = m[1] = {SHIFT:.1f}f;\n  alpha[0] = alpha[1] = 1.f;\n"),
    _sub("acc[i] *= alpha[(i >> 1) & 1];", "(void)alpha;"))

PROTO_VARIANTS = {
    "fwd_rows64": ("attention_fwd.cu", "one consumer warpgroup, 64 query rows a CTA, no turns",
                   _schedule("Rows64", "static constexpr int kConsumers = 1;")),
    "fwd_rows192": ("attention_fwd.cu", "three consumer warpgroups, 192 query rows a CTA, turns in a ring of three, "
                                        "160 registers a consumer thread",
                    _schedule("Rows192", "static constexpr int kConsumers = 3;")),
    "fwd_no_mask": ("attention_fwd.cu", "diagnostic: no key mask; the keys L..ceil128(L) are TMA zeros, score 0 and "
                                        "count in the sum",
                    _sub(_MASK, "  if (false) {\n")),
    "fwd_no_softmax": ("attention_fwd.cu", "diagnostic: P = bf16(s * scale), no max, exponent, sum or mask",
                       _sub(_SOFTMAX_START, _SOFTMAX_START + "  (void)m, (void)k0, (void)kv_len;\n"
                            "  alpha[0] = alpha[1] = 1.f;\n"
                            "  l[0] = l[1] = tq == 0 ? 1.f : 0.f;  // a row's four threads sum l to 1\n"
                            "#pragma unroll\n  for (int i = 0; i < kBlockK / 2; ++i) s[i] *= scale_log2 * 0.69314718f;\n"
                            "  return;\n")),
    "fwd_head_pair": ("attention_fwd.cu", "a CTA owns 64 query rows of heads 2p and 2p + 1, one a warpgroup; a K/V "
                                          "tile holds both heads' columns",
                      _schedule("HeadPair", "static constexpr bool kHeadPair = true;")),
    "fwd_tma_store": ("attention_fwd.cu", "O staged in shared memory and written by TMA stores",
                      _schedule("TmaStore", "static constexpr bool kTmaStore = true;")),
    "fwd_head_pair_tma_store": ("attention_fwd.cu", "fwd_head_pair, both heads' O staged as one 64-row x 128-column "
                                                    "box and written by one TMA store for the CTA",
                                _schedule("HeadPairTmaStore", "static constexpr bool kHeadPair = true;\n"
                                                              "  static constexpr bool kTmaStore = true;")),
    "fwd_q_loop": ("attention_fwd.cu", "a CTA runs every q tile of one (batch, head) in turn, K/V again from L2",
                   _schedule("QLoop", "static constexpr bool kQLoop = true;")),
    "fwd_scale_q": ("attention_fwd.cu", "the scale folded into q in the kernel (each warpgroup rounds its Q rows "
                                        "to bf16(q * scale * log2 e) in shared memory): exp2(s - m), no multiply "
                                        "per score",
                    _chain(_sub(_Q_FULL, _Q_FULL + _SCALE_Q),
                           _sub("mx[r] * scale_log2", "mx[r]"),
                           _sub(_P_EXP, "s[i] = ucod::exp2_ftz(s[i] - mu[(i >> 1) & 1]);"))),
    "fwd_mask_every_tile": ("attention_fwd.cu", "the key mask's select on every K/V tile, not only the last",
                            _sub(_MASK, "  {\n")),
    "fwd_expf": ("attention_fwd.cu", "scores in natural units and __expf (ex2 of x * log2 e), not exp2 of log2 units",
                 _chain(_sub(_SOFTMAX_START, _SOFTMAX_START + "  scale_log2 *= 0.69314718f;  // natural units\n"),
                        _sub("ucod::exp2_ftz(", "__expf("))),
    "fwd_no_overlap": ("attention_fwd.cu", "S_j and P_{j-1} V_{j-1} both waited on before S_j's softmax: the "
                                           "softmax no longer runs under the P V product",
                       _sub("ucod::wgmma_wait<1>();", "ucod::wgmma_wait<0>();")),
    "fwd_shift": ("attention_fwd.cu", f"a constant shift of {SHIFT:g} (log2 units) for the row max: no max, "
                                      "shuffles or O rescale",
                  _SHIFT),
    "fwd_shift_bf16": ("attention_fwd.cu", "fwd_shift, with the sum over the bf16 P that P V takes",
                       _chain(_SHIFT, _sub(_SUM, "    s[i] = __bfloat162float(__float2bfloat16_rn(s[i]));  "
                                                 "// P as P V takes it\n" + _SUM))),
}
PROTO_VARIANTS["fwd_no_overlap_no_pingpong"] = (
    "attention_fwd.cu", "fwd_no_overlap without the consumers' turns",
    _chain(PROTO_VARIANTS["fwd_no_overlap"][2], VARIANTS["fwd_no_pingpong"][2]))
VARIANTS.update(PROTO_VARIANTS)

MICRO = "scripts/microbench"
# Each TPU prototype's pallas_call (file:line), what it asked of the TPU
# kernel, and the K1 variants that ask it of the H100 (timed at bs16 L1370,
# and bench_attention_756.py's at bs8 L2917)
SITES = {
    f"{MICRO}/bench_attention.py:107": ("q-block size; the softmax's denominator folded into O; the mask's cost; "
                                        "the matmul floor", ("fwd_rows64", "fwd_rows192", "fwd_no_mask",
                                                             "fwd_no_softmax")),
    f"{MICRO}/bench_attention2.py:87": ("two heads per program, one 128-lane store",
                                        ("fwd_head_pair_tma_store", "fwd_head_pair", "fwd_tma_store")),
    f"{MICRO}/bench_attention2.py:146": ("an in-kernel q-block loop over resident K/V", ("fwd_q_loop",)),
    f"{MICRO}/bench_attention4.py:63": ("the scale on q, not on the scores", ("fwd_scale_q",)),
    f"{MICRO}/bench_attention5.py:82": ("the mask as one add; exp2", ("fwd_mask_every_tile", "fwd_expf")),
    f"{MICRO}/bench_attention6.py:90": ("two heads' QK, softmax and PV interleaved", ("fwd_no_overlap",
                                                                                     "fwd_no_overlap_no_pingpong")),
    f"{MICRO}/bench_attention7.py:83": ("a constant shift in place of the row max", ("fwd_shift", "fwd_shift_bf16")),
    f"{MICRO}/bench_attention_756.py:27": ("q-block size at L 2917", ("fwd_rows64", "fwd_rows192")),
}
SITE_756 = f"{MICRO}/bench_attention_756.py:27"
ROW_VARIANTS = SITES[SITE_756][1]


def _split(x, heads):
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2).float()


def _merge(o, dtype):
    b, h, l, hd = o.shape
    return o.transpose(1, 2).reshape(b, l, h * hd).to(dtype)


def no_mask(q, k, v, heads, scale):
    """fwd_no_mask's function: softmax(q k^T scale) v over the keys
    zero-padded to a multiple of 128, as TMA fills the last tile: the
    padded keys score 0 and count in the sum (the TPU prototype's padded
    ``nomask``)."""
    kp, vp = (F.pad(x, (0, 0, 0, -x.shape[1] % 128)) for x in (k, v))
    p = torch.softmax(_split(q, heads) @ _split(kp, heads).transpose(-1, -2) * scale, -1)
    return _merge(p.to(q.dtype).float() @ _split(vp, heads), q.dtype)


def no_softmax(q, k, v, heads, scale):
    """fwd_no_softmax's function: bf16(q k^T scale) v."""
    p = (_split(q, heads) @ _split(k, heads).transpose(-1, -2) * scale).to(q.dtype)
    return _merge(p.float() @ _split(v, heads), q.dtype)


def shift(q, k, v, heads, scale, bf16_sum=False):
    """fwd_shift's function, the constant-shift softmax of the JAX
    production kernel (its default, rowmax=False): p = 2^(s scale log2 e -
    30), o = bf16(p) v / sum p, the sum over the f32 p, or with
    ``bf16_sum`` (fwd_shift_bf16, and the JAX kernel) over the bf16 p."""
    p = torch.exp2(_split(q, heads) @ _split(k, heads).transpose(-1, -2) * (scale * A._LOG2E) - SHIFT)
    pb = p.to(q.dtype).float()
    return _merge(pb @ _split(v, heads) / (pb if bf16_sum else p).sum(-1, keepdim=True), q.dtype)


def scale_q(q, scale):
    """bf16(q scale log2 e): the q that fwd_scale_q's S products take, its
    kernel having scaled and rounded q's tiles in shared memory."""
    return (q.float() * (scale * A._LOG2E)).to(q.dtype)


def scaled_q(q, k, v, heads, scale):
    """fwd_scale_q's function of the original q: plain attention on q
    scaled and rounded to bf16 as ``scale_q`` gives it."""
    return A.packed_attention_reference(scale_q(q, scale), k, v, heads, math.log(2.0))


# each prototype variant's plain function of the original (q, k, v, heads, scale)
_PLAIN = {"fwd_no_mask": no_mask, "fwd_no_softmax": no_softmax, "fwd_scale_q": scaled_q, "fwd_shift": shift,
          "fwd_shift_bf16": lambda *a: shift(*a, bf16_sum=True)}


def plain_of(name: str):
    """The plain PyTorch function variant ``name`` computes: K1's for those
    that compute K1's function."""
    return _PLAIN.get(name, A.packed_attention_reference)


LAUNCHES = collections.Counter()  # launches of each variant by variant_fn's calls


def variant_fn(lib, name: str):
    """Variant ``name``'s forward entry in ``lib`` as (q, k, v, out=None) ->
    out at head dim 64 and SCALE; each launch adds one to LAUNCHES[name]."""
    fn = getattr(lib, f"ucod_attention_fwd_{name}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, out=None):
        out = torch.empty_like(q) if out is None else out
        b, l, d = q.shape
        _build.check_cuda(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, d // 64, 64,
                             SCALE * A._LOG2E, _stream()), name)
        LAUNCHES[name] += 1
        return out

    return call


def prototype_variants(lib, names, results: dict) -> None:
    """Each prototype variant of ``names`` against its plain function
    (raises past TOL) and timed against K1 by the card's own time,
    interleaved K1, variant, variant, K1, at SHAPES, the row variants also
    at SHAPE_756."""
    _log("K1 variants that port the TPU attention prototypes (interleaved K1, variant, variant, K1; card time):")
    for b, l in (*SHAPES, SHAPE_756):
        q, k, v = _inputs(b, l)[:3]
        for name in names:
            if (b, l) == SHAPE_756 and name not in ROW_VARIANTS:
                continue
            run = variant_fn(lib, name)
            out = run(q, k, v, out=torch.full_like(q, float("nan")))
            ref = plain_of(name)(q, k, v, HEADS, SCALE).float()
            err = (out.float() - ref).abs().max().item()
            if not err <= TOL * ref.abs().max().item():  # NaN fails too
                raise AssertionError(f"{name} bs{b} L{l}: max |variant - plain| {err} exceeds "
                                     f"{TOL} * max|plain| {ref.abs().max().item()}")
            k1_ms, ms = _ab_ms(lambda: A.packed_attention(q, k, v, HEADS, SCALE), lambda: run(q, k, v), _device_ms)
            _log(f"  bs{b} L{l} {name} ({VARIANTS[name][1]}): {ms:.4f} ms against K1's {k1_ms:.4f} ms "
                 f"({ms / k1_ms:.3f}x); max |variant - plain| {err:.4g}")
            results[f"variant {name} bs{b} L{l}"] = {"ms": ms, "k1_ms": k1_ms, "max_abs_err": err}

_ENTRIES = ("ucod_attention_fwd_lse", "ucod_attention_fwd", "ucod_attention_bwd")


def variant_text(name, variants=VARIANTS, entries=_ENTRIES) -> str:
    """The source that variant ``name`` builds from: its edit of its source
    file, each C entry of ``entries`` renamed with the suffix _<name>."""
    src_name, _, edit = variants[name]
    src = edit(variant_source(src_name))
    for entry in entries:
        src = src.replace(f'extern "C" int {entry}(', f'extern "C" int {entry}_{name}(')
    return src


def build_variants(names, variants=VARIANTS, entries=_ENTRIES, subdir="variants"):
    """Write, compile and link the variants (name -> (source file, what it
    changes, edit) in ``variants``; each C entry of ``entries`` renamed with
    the suffix _<name>) -> the loaded library."""
    out = _build.BUILD_ROOT / subdir
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(variant_text(name, variants, entries))
        obj = out / f"{name}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", str(cu), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, p in zip(names, procs):
        text = p.communicate()[0]
        (out / f"{name}.log").write_text(text)
        if p.returncode:
            failed.append(f"variant {name} failed to build:\n{text[-3000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    lib = out / "libvariants.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def variants(results: dict, names=None) -> None:
    names = list(names or VARIANTS)
    lib = build_variants(names)
    prototype_variants(lib, [n for n in names if n in PROTO_VARIANTS], results)
    names = [n for n in names if n not in PROTO_VARIANTS]
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _log("variants of this tree's kernels (interleaved this, variant, variant, this):")
    for (b, l), hd in [(shape, hd) for hd in (64, 128) for shape in SHAPES] if names else ():
        at_hd = [n for n in names if n.startswith("bwd128_") == (hd == 128)]
        if not at_hd:
            continue
        HEADS, SCALE = _hs(hd)
        q, k, v, do, o, lse = _inputs(b, l, hd=hd)
        ref_o = A.packed_attention(q, k, v, HEADS, SCALE)
        ref_g = A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)
        for name in at_hd:
            src_name, what, _ = VARIANTS[name]
            if src_name == "attention_fwd.cu":
                fn = getattr(lib, f"ucod_attention_fwd_{name}")
                fn.argtypes = [ptr] * 4 + [i32, i32, i32, i32, f32, ptr]

                def run(fn=fn):
                    out = torch.empty_like(q)
                    _build.check_cuda(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, HEADS, 64,
                                         SCALE * A._LOG2E, _stream()), name)
                    return (out,)

                this, refs = (lambda: A.packed_attention(q, k, v, HEADS, SCALE)), (ref_o,)
            else:
                fn = getattr(lib, f"ucod_attention_bwd_{name}")
                fn.argtypes = [ptr] * 11 + [i32, i32, i32, i32, i32, f32, i32, ptr]

                def run(fn=fn):
                    grads = [torch.empty_like(q) for _ in range(3)]
                    stats, dq_acc = A.bwd_scratch(b, l, HEADS, q.device, hd)
                    _build.check_cuda(fn(*(x.data_ptr() for x in (q, k, v, o, do, lse, stats, dq_acc, *grads)), b, l,
                                         l, HEADS, hd, SCALE, 0, _stream()), name)
                    return grads

                this, refs = (lambda: A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)), ref_g
            diff = max((x.float() - r.float()).abs().max().item() for x, r in zip(run(), refs))
            base_ms, ms = _ab_ms(this, run)
            _log(f"  bs{b} L{l} hd{hd} {name} ({what}): {ms:.4f} ms against {base_ms:.4f} ms; "
                 f"largest difference {diff:.4g}")
            results[f"variant {name} bs{b} L{l}"] = {"ms": ms, "this_ms": base_ms, "max_abs_diff": diff}


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKRED", "UBLKCP", "HMMA", "MUFU.EX2")


def _sass(obj: Path, label: str, results: dict, ops=SASS_OPS) -> None:
    """Counts of ``ops`` in the object ``obj``, in all and per kernel
    function (``cuobjdump -sass`` sections; a template instantiation named
    by its mangled arguments, e.g. ILi64ELb0E13__nv_bfloat16NS_8ScheduleEEEv
    = <64, false, bf16, Schedule>)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def count(text):
        return {op: len(re.findall(rf"\b{re.escape(op)}\b", text)) for op in ops}

    sass = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True, text=True, check=True).stdout
    results[f"sass {label}"] = count(sass)
    _log(f"SASS of {label}: {results[f'sass {label}']}")
    for section in sass.split("Function : ")[1:]:
        name = re.sub(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", section.split(None, 1)[0])
        kernel = re.search(r"([a-z][a-z_0-9]*_kernel)(I.+?Ev)?", name)
        key = f"{label} {kernel.group(1) + (kernel.group(2) or '') if kernel else name[:80]}"
        results[f"sass {key}"] = count(section)
        _log(f"  {key}: {results[f'sass {key}']}")


def _sass_streams(obj: Path) -> dict:
    """Each kernel function's SASS in ``obj`` as a tuple of its instructions
    (addresses and names dropped), by its mangled name without the
    anonymous namespace's tag (a hash of the build's source path)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True, text=True, check=True).stdout
    streams = {}
    for section in sass.split("Function : ")[1:]:
        name = re.sub(r"\d*_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", section.split(None, 1)[0])
        lines = (re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip() for line in section.splitlines()[1:])
        streams[name] = tuple(line for line in lines if re.match(r"[@A-Z]", line))
    return streams


def sass_against_parent(parent: Path, results: dict, sources=("attention_fwd", "attention_bwd")) -> None:
    """Whether each kernel of each object of ``sources`` has the parent
    checkout's SASS instruction for instruction (kernels paired by their
    mangled names), and how many positions differ where it does not."""
    path, _ = _build.build()
    parent_path, _ = _parent_build(parent).build()
    for src in sources:
        this, old = _sass_streams(path.parent / f"{src}.o"), _sass_streams(parent_path.parent / f"{src}.o")
        kernels = {}
        for name in sorted(set(this) | set(old)):
            a, b = this.get(name, ()), old.get(name, ())
            kernel = re.search(r"([a-z][a-z_0-9]*_kernel)(I.+?Ev)?", name)
            kernels[kernel.group(0) if kernel else name[:80]] = {
                "same": a == b, "instructions": (len(a), len(b)),
                "differ": sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))}
        results[f"sass {src}.o against the parent"] = {"same": this == old, "kernels": kernels}
        _log(f"SASS of {src}.o against the parent's: the same instruction for instruction: {this == old}; "
             f"per kernel (this, parent; positions that differ): {kernels}")


def ptxas_report(results: dict, sources=("attention_fwd", "attention_bwd")) -> None:
    """ptxas's report (registers, spills, shared memory, C75xx warnings) of
    each object of ``sources``, from the build's log."""
    path, _ = _build.build()
    log_path = path.parent / "build.log"
    sections = log_path.read_text().split(_build._nvcc() + " ") if log_path.exists() else []
    for src in sources:
        lines = [line.strip() for section in sections if f"/{src}.cu " in section.split("\n", 1)[0]
                 for line in section.splitlines()[1:] if re.search(r"ptxas|spill|C75\d\d", line)]
        results[f"ptxas {src}"] = lines
        _log(f"ptxas report of {src}.cu (build.log):")
        for line in lines:
            _log(f"  {line}")


def sass_counts(results: dict, sources=("attention_fwd", "attention_bwd"), ops=SASS_OPS) -> None:
    """``_sass`` of each built object of ``sources`` in the main library."""
    path, _ = _build.build()
    for src in sources:
        _sass(path.parent / f"{src}.o", f"{src}.o", results, ops)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of the parent tree to time against")
    parser.add_argument("--variants", nargs="*", choices=sorted(VARIANTS), default=None,
                        help="time the source variants in VARIANTS (all, or those named)")
    parser.add_argument("--sass", action="store_true", help="count instructions in the attention objects' SASS")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(smi)
    results = {"card": smi}
    if args.sass:
        sass_counts(results)
        ptxas_report(results)
        if args.parent is not None:
            sass_against_parent(args.parent, results)
    library(results)
    for hd in HEAD_DIMS:
        library_at(results, hd)
        trace_backward(hd)
    if args.parent is not None:
        for hd in HEAD_DIMS:
            parent_ab(args.parent, results, hd)
    if args.variants is not None:
        variants(results, args.variants)
        if args.sass:  # the variants' objects, as variants() built them
            for name in args.variants or VARIANTS:
                _sass(_build.BUILD_ROOT / "variants" / f"{name}.o", f"variant {name}.o", results)
    _log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
