"""Same-process timing of the port's attention kernels on the card.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.attention_ab [--parent DIR] [--variants [NAME ...]] [--sass]

Always: the card's name and power limit (nvidia-smi), then the forward (K1),
the forward with log-sum-exp (K2) and the backward (K3/K4) at bs16 L1370 and
bs4 L2917 (12 heads of 64, bf16), each beside one
``scaled_dot_product_attention`` call on the same tensors (its backward for
the backward), the forward at K5's shapes (per-head (48, 1370, 64) and the
tensor-parallel shard's packed (16, 1370, 3 * 64)) beside SDPA, and a
torch.profiler breakdown of the backward's kernels.

* ``--parent DIR``: DIR is a checkout of a parent tree whose
  ``ucod_attention_fwd`` takes a head-dim argument and whose
  ``ucod_attention_fwd_lse`` and ``ucod_attention_bwd`` take no key bound
  and no f32-output flag.  Its kernels are built from DIR by DIR's own
  ``ops/_build.py`` and timed against this tree's, interleaved parent,
  this, this, parent, at bs16 L1370 and bs4 L2917; the outputs of the two
  are compared bit for bit (K1, K2's o and log-sum-exp, dq, dk, dv).
* ``--variants [NAME ...]``: variants of this tree's kernels (all, or those
  named), each an edit of its source (``VARIANTS``; the shared flash-loop
  header ``attention_common.cuh`` written into it, see ``variant_source``), built into ``build/ucod_dpl_tpu_torch/variants/`` and timed
  interleaved against the kernel it varies.  Variants marked "diagnostic"
  compute a wrong result on purpose: they show what one part costs.
* ``--sass``: instruction counts in the SASS of the built attention objects
  (``cuobjdump -sass``), per object and per kernel instantiation: HGMMA
  (wgmma), UTMALDG (TMA loads), UBLKRED (bulk reduce-add), HMMA (mma.sync),
  MUFU.EX2.

Exits 1 without a CUDA device.  Times are CUDA-event means over 20 calls
after 3 warm-ups, each the mean of its two interleaved runs.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from ucod_dpl_tpu_torch.ops import _build
from ucod_dpl_tpu_torch.ops import attention as A

HEADS, SCALE = 12, 0.125
SHAPES = ((16, 1370), (4, 2917))


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


def _ab_ms(a, b):
    """Interleaved a, b, b, a -> (a ms, b ms), each the mean of its two runs."""
    a1, b1, b2, a2 = _time_ms(a), _time_ms(b), _time_ms(b), _time_ms(a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _inputs(b: int, l: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, l, HEADS * 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    o, lse = A.packed_attention_fwd_lse(q, k, v, HEADS, SCALE)
    return q, k, v, do, o, lse


def _heads(x):
    b, l, d = x.shape
    return x.view(b, l, HEADS, d // HEADS).transpose(1, 2)


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
    for b, l in SHAPES:
        q, k, v, do, o, lse = _inputs(b, l)
        hq, hk, hv = (_heads(x).detach().requires_grad_(True) for x in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(hq, hk, hv, scale=SCALE)
        row = {
            "K1": _time_ms(lambda: A.packed_attention(q, k, v, HEADS, SCALE)),
            "K2": _time_ms(lambda: A.packed_attention_fwd_lse(q, k, v, HEADS, SCALE)),
            "bwd": _time_ms(lambda: A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)),
            "sdpa_fwd": _time_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv, scale=SCALE)),
            "sdpa_bwd": _time_ms(lambda: torch.autograd.grad(o_sdpa, (hq, hk, hv), _heads(do), retain_graph=True)),
        }
        results[f"bs{b} L{l}"] = row
        _log(f"bs{b} L{l}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()))


def trace_backward() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, o, lse = _inputs(16, 1370)
    for _ in range(2):
        A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)
        torch.cuda.synchronize()
    _log("backward bs16 L1370, device time per call by kernel (torch.profiler, 5 calls):")
    for e in sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total):
        _log(f"  {e.self_device_time_total / 5e3:.4f} ms  {e.key[:100]}")


# ---- the parent's kernels ---------------------------------------------------

def _parent_lib(parent: Path):
    spec = importlib.util.spec_from_file_location("parent_build", parent / "ucod_dpl_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernels()


def parent_ab(parent: Path, results: dict) -> None:
    """The parent's K1, K2 and backward (its C entries: the forward with a
    head-dim argument, the forward with log-sum-exp and the backward
    without a key bound or an f32-output flag) against this tree's at the
    same shapes: whether the outputs are equal bit for bit, and their times
    interleaved parent, this, this, parent."""
    lib = _parent_lib(parent)  # its own _build declares its entries' C signatures

    def fwd(q, k, v):
        o = torch.empty_like(q)
        b, l, _ = q.shape
        _build.check_cuda(lib.ucod_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, HEADS,
                                                 64, SCALE * A._LOG2E, _stream()), "parent fwd")
        return o

    def fwd_lse(q, k, v):
        o = torch.empty_like(q)
        b, l, _ = q.shape
        lse = torch.empty(b, HEADS, l, device=q.device)
        _build.check_cuda(lib.ucod_attention_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                                     lse.data_ptr(), b, l, HEADS, SCALE * A._LOG2E, _stream()),
                          "parent fwd_lse")
        return o, lse

    def bwd(q, k, v, o, do, lse):
        grads = [torch.empty_like(q) for _ in range(3)]
        b, l, _ = q.shape
        stats, dq_acc = A.bwd_scratch(b, l, HEADS, q.device)
        _build.check_cuda(lib.ucod_attention_bwd(*(x.data_ptr() for x in (q, k, v, o, do, lse, stats, dq_acc, *grads)),
                                                 b, l, HEADS, SCALE, _stream()), "parent bwd")
        return grads

    _log(f"parent {parent} against this tree (interleaved parent, this, this, parent):")
    for b, l in SHAPES:
        q, k, v, do, o, lse = _inputs(b, l)
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
            _log(f"  bs{b} L{l} {name}: parent {row[name][0]:.4f} ms, this {row[name][1]:.4f} ms "
                 f"({row[name][0] / row[name][1]:.3f}x)")
        _log(f"  bs{b} L{l} equal bit for bit, parent vs this: {equal}")
        results[f"parent bs{b} L{l}"] = {**row, "equal": equal}


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
          *reinterpret_cast<float2*>(half + dq_half_offset(row, col)) = make_float2(dq[4 * jb], dq[4 * jb + 1]);
          *reinterpret_cast<float2*>(half + dq_half_offset(row + 8, col)) = make_float2(dq[4 * jb + 2], dq[4 * jb + 3]);
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
                 _sub("n_work < n_sm ? n_work : n_sm", "n_work")),
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
                           _sub("    *reinterpret_cast<float2*>(out + dq_half_offset(row, col)) = make_float2(",
                                "    atomicAdd(reinterpret_cast<float2*>(out + dq_half_offset(row, col)), make_float2("),
                           _sub("    *reinterpret_cast<float2*>(out + dq_half_offset(row + 8, col)) = make_float2(",
                                "    atomicAdd(reinterpret_cast<float2*>(out + dq_half_offset(row + 8, col)), make_float2("),
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
}
_ENTRIES = ("ucod_attention_fwd_lse", "ucod_attention_fwd", "ucod_attention_bwd")


def build_variants(names, variants=VARIANTS, entries=_ENTRIES, subdir="variants"):
    """Write, compile and link the variants (name -> (source file, what it
    changes, edit) in ``variants``; each C entry of ``entries`` renamed with
    the suffix _<name>) -> the loaded library."""
    out = _build.BUILD_ROOT / subdir
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for name in names:
        src_name, _, edit = variants[name]
        src = edit(variant_source(src_name))
        for entry in entries:
            src = src.replace(f'extern "C" int {entry}(', f'extern "C" int {entry}_{name}(')
        cu = out / f"{name}.cu"
        cu.write_text(src)
        obj = out / f"{name}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", str(cu), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, p in zip(names, procs):
        text = p.communicate()[0]
        (out / f"{name}.log").write_text(text)
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{text[-4000:]}")
    lib = out / "libvariants.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def variants(results: dict, names=None) -> None:
    names = list(names or VARIANTS)
    lib = build_variants(names)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    _log("variants of this tree's kernels (interleaved this, variant, variant, this):")
    for b, l in SHAPES:
        q, k, v, do, o, lse = _inputs(b, l)
        ref_o = A.packed_attention(q, k, v, HEADS, SCALE)
        ref_g = A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)
        for name in names:
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
                fn.argtypes = [ptr] * 11 + [i32, i32, i32, i32, f32, i32, ptr]

                def run(fn=fn):
                    grads = [torch.empty_like(q) for _ in range(3)]
                    stats, dq_acc = A.bwd_scratch(b, l, HEADS, q.device)
                    _build.check_cuda(fn(*(x.data_ptr() for x in (q, k, v, o, do, lse, stats, dq_acc, *grads)), b, l,
                                         l, HEADS, SCALE, 0, _stream()), name)
                    return grads

                this, refs = (lambda: A.packed_attention_bwd(q, k, v, o, do, lse, HEADS, SCALE)), ref_g
            diff = max((x.float() - r.float()).abs().max().item() for x, r in zip(run(), refs))
            base_ms, ms = _ab_ms(this, run)
            _log(f"  bs{b} L{l} {name} ({what}): {ms:.4f} ms against {base_ms:.4f} ms; "
                 f"largest difference {diff:.4g}")
            results[f"variant {name} bs{b} L{l}"] = {"ms": ms, "this_ms": base_ms, "max_abs_diff": diff}


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKRED", "UBLKCP", "HMMA", "MUFU.EX2")


def sass_counts(results: dict, sources=("attention_fwd", "attention_bwd"), ops=SASS_OPS) -> None:
    """Counts of ``ops`` in each built object of ``sources``, in all and per
    kernel function (``cuobjdump -sass`` sections; a template instantiation
    named by its mangled arguments, e.g. ILi64ELb0E = <64, false>)."""
    path, _ = _build.build()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def count(text):
        return {op: len(re.findall(rf"\b{re.escape(op)}\b", text)) for op in ops}

    for src in sources:
        sass = subprocess.run([str(cuobjdump), "-sass", str(path.parent / f"{src}.o")], capture_output=True,
                              text=True, check=True).stdout
        results[f"sass {src}.o"] = count(sass)
        _log(f"SASS of {src}.o: {results[f'sass {src}.o']}")
        for section in sass.split("Function : ")[1:]:
            name = section.split(None, 1)[0]
            kernel = re.search(r"([a-z_]+_kernel)(I(?:L[a-z]+\d+E)+E)?", name)
            label = f"{src}.o {kernel.group(1) + (kernel.group(2) or '') if kernel else name[:80]}"
            results[f"sass {label}"] = count(section)
            _log(f"  {label}: {results[f'sass {label}']}")


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
    library(results)
    trace_backward()
    if args.parent is not None:
        parent_ab(args.parent, results)
    if args.variants is not None:
        variants(results, args.variants)
    _log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
