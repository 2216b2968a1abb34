#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port, ``ucod_dpl_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from ``ucod_dpl_tpu_torch/csrc``;
  3. K1 (packed attention) against its plain PyTorch version, bf16, at the
     serving shape and at L = 257 / 2917, with large logits, with NaN rows
     past L in memory, and at L = 65 / 1 (a last tile of padding);
  4. K6 (fused LayerNorm + q/k/v) against its plain version at bs16 L1370,
     bs3 L257 and 1, 127, 128 and 129 rows, NaN past the input and in the
     outputs;
  5. serving: a full-width dinov2-base Predictor at 518px (seeded random
     weights) answers requests of 16, 5 and 1 images (buckets 16, 8, 1) and
     one soft request; K1 and K6 each launch 11 times per forward;
  6. composed accuracy: ``fg_logits_live`` through the kernels in bf16 is no
     further from the float32 plain path than the bf16 plain path is
     (err <= 1.5 * err_plain + 1e-3);
  7. timing with CUDA events: K1 and K6 against their plain versions at the
     serving shape (K6 also beside one cuBLAS product of the normalised h
     with the concatenated q/k/v weight, the GEMM alone), and the port's
     ``fg_logits_live`` img/s at bs16 518px;
  A. (after phase 4) the attention forward with log-sum-exp and the flash
     backward against their plain versions, bf16, at L = 1370 (bs16), 2917
     (bs4), 257, 65, 1, with large logits (q x3), every output pre-filled
     with NaN and NaN in memory past the inputs;
  B. training: three LoRA joint steps (``make_lora_train_step``) at full
     width, bs16 518px bf16, remat none, each with a finite loss, moving
     adapters and 11 forward-LSE and 11 backward launches (no K1/K6), then a
     discriminator step; at bs4, the third step's decoder + LoRA gradients
     through the kernels against the plain path (norm-relative <= 0.1, and
     the LoRA gradients alone too);
  C. timing: attention forward + backward per call at bs16 L1370 and bs4
     L2917, the forward-LSE and backward kernels alone, and the LoRA step at
     bs16 518px, kernels against plain (the plain step only if it fits),
     and with remat "layer"; a torch.profiler trace of the LoRA step;
  D. the int8 kernels K8 (LN + quantize + q/k/v), K9 (LN + quantize + fc1 +
     GELU + requantize), K10 (quantize + out-projection) and K11 (the whole
     int8 MLP half) against their plain versions, bf16, at bs16 L1370 and at
     B*L = 1, 17, 63, 64, 65, 127, 128, 129 and 1370*4 + 3 rows (both sides
     of the 64- and 128-row tiles), cases with rows over six decades
     of scale, an all-zero and a constant row; outputs pre-filled with NaN
     (codes with -128, which no code takes), NaN in memory past the inputs;
     K11 also equal bit for bit to the split kernel path (K9's kernel, then
     ``dense_w8a8_pre``) on the same x;
  E. int8 serving: a full-width dinov2-base ``Predictor(quantize="int8")``
     at 518px answers requests of 16, 5 and 1 images; per forward K8, K10,
     K9 and K1 launch 11 times each, K6 and K11 never; then one
     ``fg_logits_live(..., int8_mlp="whole")`` forward: K11 11 times, no K9;
  F. composed int8 accuracy at bs4 518px against the float32 plain path:
     err(int8 kernels) <= 1.5 * err(int8 plain) + 1e-3, and the int8 masks
     agree with the float32 masks on more than 90% of the pixels;
  G. timing: K8-K11 against their plain versions at bs16 L1370 (CUDA
     events around back-to-back calls, as every kernel is timed, and
     beside them the card's own time, ``device_ms``: events around calls
     queued behind a sleep kernel); K11 against the split MLP half (K9,
     then ``dense_w8a8_pre``) on the same x; K8 against
     K6 on the same x (K6 on the same layer's bf16 weights); the int8 GEMM
     alone (``torch._int_mm`` at K8's and K9's shapes, a yardstick); a
     torch.profiler split of K8-K11 into pre-pass and main kernel;
     ``fg_logits_live`` at bs16 518px with the int8 kernels (split and
     whole MLP), the int8 plain path and the bf16 kernels, interleaved in
     one process, with a trace of each int8 kernel forward;
  H. K5 (per-head attention: the forward kernel on the per-head layout)
     against its plain version, bf16, at (BH, L, d) = (48, 1370, 64) (a
     tensor-parallel shard's heads), (80, 257, 32), (4, 2917, 64), (3, 65,
     16) and (1, 1, 128), with large logits, NaN-filled outputs and NaN in
     memory past the inputs; odd head counts at d 16, 32 and 128 on the
     packed layout; ``multi_head_attention`` with 3 heads launches the packed
     forward once and K5's wrapper never;
  I. tensor-parallel feature extraction: a full-width dinov2-base
     ``FeatureExtractor(mesh=build_mesh({"data": 1, "model": 4}, devices=[cuda:0] * 4))``
     extracts a bs16 518px bf16 batch: finite features, the packed forward
     launched 44 times (11 layers x 4 shards of 3 heads) and nothing else,
     and err(TP kernels vs f32 unsharded plain) <= 1.5 * err(bf16 unsharded
     plain) + 1e-3; then ``{"data": 2, "model": 2}``: 44 launches (6 heads a
     shard); timing of the TP extract against the unsharded one, interleaved;
  J. K7 (LayerNorm + fc1 + GELU) against its plain version at bs16 L1370
     (D 768, F 3072) and at 1, 17, 65 and 1370 * 4 + 3 rows, NaN-filled
     outputs; then the MLP halves of the 11 layers of the serving backbone
     through K7 (11 launches), and timing (by events and by the card's
     own time) of K7 against its plain version and against LN + dense +
     GELU as the layer composes them, and of one layer's MLP half with K7
     against the composed one;
  K. the eval entry: ``ucod_dpl_tpu_torch.cli.eval_main`` on
     configs/uscod/UCOD-DPL_dinov2.py (seeded random dinov2-base, 518px,
     bf16; a seeded decoder checkpoint) over a synthetic RefCOD layout of 32
     JPEG images at 480x640, 600x800 and 720x1280 with one ground-truth blob
     each, ``look_twice_th`` 0.95 (the crop path): the first run builds the
     feature cache (4 batches of 8) and K1 and K6 launch 11 times per
     backbone forward (cache batches and crop batches), nothing else; 32
     finite (37, 37, 768) float32 cache entries, 32 masks at their
     ground-truth sizes, nine metrics finite in [0, 1]; a second run reads
     the cache (crop batches only) to the same metrics; the cached features
     of 4 images no further from the f32 plain path than the bf16 plain
     path is (err <= 1.5 * err_plain + 1e-3); host-clock cache-build and
     eval img/s, the eval's time by stage, the crop count, a profiler split
     of one cache-build batch and the device's busy share of an eval from
     the cache.  The kernels line's K1/K6 launches are this phase's first
     run's (the serving phase's beside them);
  M. pseudo-labels: ``ucod_dpl_tpu_torch.cli.generate_pseudo_label_main``
     at full width (seeded random dinov2-base, 224px, bf16, batch 16) over
     48 synthetic train images in two directories (TR-CAMO+TR-COD10K): K1
     and K6 launch 11 times per batch forward and nothing else; 48 binary
     (16, 16, 1) float32 entries and the meta ``n``, ``fingerprint``,
     ``th_bkg``; on 4 images the kernel path's CLS attention and key
     tokens no further from the f32 plain path than 1.5 x the bf16 plain
     path's error + 1e-3, and its masks differing from the f32 path's on
     no more than 1.5 x the bf16 plain path's share + 0.002 of the pixels;
     img/s by host clock from the first batch, and the device's busy share
     of a regeneration (``--overwrite``) under the profiler;
  L. the train entry: ``ucod_dpl_tpu_torch.cli.train_main`` on
     configs/uscod/UCOD-DPL_dinov2.py at full width (seeded random
     dinov2-base, 518px, bf16, batch 16; the Runner's seeded decoder towers
     loaded with ``--load_from``, their fg biases at the 60th percentile of
     their logits) over phase M's 48 train images and the pseudo-label
     cache it generated, and 8 val images (TE-CAMO).  Run A, cached
     features: 4 epochs of 3 steps, discriminator passes at epochs 0 and 2,
     the finetune switch at epoch 3, saves (``save_mode`` all) and
     validations at epochs 2 and 4; finite losses, moved decoder, EMA and
     discriminator, the epoch files, a best result, LookTwice crops, and K1
     and K6 11 times per backbone forward of the cache builds and crop calls
     and nothing else; rates, a profiler trace of one epoch.  Run B: the
     same, SIGTERM after its 7th decoder step, exit 128 + 15 with
     ``state_preempt`` at epoch 2, batch 1 of the train phase, then
     ``--resume`` to the end: bitwise equal to run A (cuDNN deterministic in
     every run).  Run C, LoRA (the shipped config's rank 2, alpha 4, lr
     1e-4, remat none), 2 epochs: 11 forward-LSE and 11 backward launches per LoRA step,
     11 forward-LSE per discriminator batch (its adapted forward), K1/K6
     only in the crop calls; the adapters move; the adapter, merged-backbone
     and state-pair files; the merged backbone loads in a
     ``FeatureExtractor`` and its features differ from the base backbone's;
     LoRA step ms by CUDA events and host clock, a trace of one epoch.  Run
     D: run C with SIGTERM after its 4th LoRA step (``state_preempt`` at
     epoch 1, batch 1), resumed: bitwise equal to run C, the adapters
     included (the backward's dQ is summed in a fixed order).  The kernels
     line gives each kernel's launches in runs A and C (``train_launches``,
     ``lora_train_launches``);
  N. CORAL stage 2: ``ucod_dpl_tpu_torch.cli.lt_eval_main`` on
     configs/uscod/CORAL_dinov2.py as shipped apart from paths (val batch 1,
     window size 3, length 56, no m-patches), with phase L's seeded decoder
     (``--load_from``) and a seeded refiner file (``--refiner_path``), over
     16 synthetic val images at phase K's sizes, twice: the first run
     builds the feature cache and the 3 x 3 grid-patch cache, and K1 and K6
     launch 11 times per forward (cache batches, grid batches, the two
     forwards of each centre-crop fallback) and nothing else; metrics finite
     in [0, 1] and the same from the caches; 16 grid-patch entries of (9,
     37, 37, 768) and 16 masks at their ground-truth sizes; the refined
     logits of 4 images on the kernel path's features no further from the
     f32 plain path's than 1.5 x the bf16 plain path's error + 1e-3;
     ``RefinePredictor`` with m-patches (a 756px forward, L 2917) and, from
     the shipped config, with ``quantize="int8"`` (K8, K1, K10 and K9 11
     times per forward, no K6): launches and img/s by host clock.  The
     kernels line gives each kernel's launches in phases M and N
     (``pseudo_label_launches``, ``coral_eval_launches``,
     ``refine_serving_launches``, ``refine_int8_launches``).
Every kernel is also timed against one PyTorch call of the same function
where one exists (``scaled_dot_product_attention`` for K1, K2 and K5 (at the
per-head shape and at the tensor-parallel shard's packed (16, 1370, 3 * 64))
and its backward for K3/K4), and each kernel's bound (the larger of its bytes over
3.35 TB/s and its operations over 989 TFLOP/s bf16 or 1,979 TOP/s int8, the
H100 SXM's published peaks) is computed from the shapes timed.
The second-to-last line is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances of the kernels against their plain versions, as a fraction of
# max|plain output|.  K1: both sides round p and o to bf16 (one ulp is 2^-8 to
# 2^-7 relative); on an H100 they differ by one ulp of the largest output at
# every shape checked here, so the bound is 4 * 2^-8 = 2^-6 of max|plain|.
# Scaled to the output, not to v: at unit-scale q the output averages about
# L/e keys and max|o| is 0.3-1 while max|v| is about 5, so a bound on max|v|
# would pass a kernel whose padded keys leak a few percent of the weight.
# K6: both sides round the normalised h and the output to bf16 and the plain
# version also rounds before its bias add, a few bf16 ulps of the output; the
# bound is 2% of max|plain|.  Both sit far below the error of a wrong head,
# tile, row, mask or rescale.
K1_TOL = 2.0 ** -6
K6_TOL = 0.02
# Forward with log-sum-exp (K2's port) and the backward (K3/K4's port)
# against their plain versions on the same bf16 inputs.  o: K1's bound (the
# same kernel).  lse: 1e-3 absolute; both sides sum the same f32 terms in
# another order, a few f32 ulps of ln(L) apart (about 1e-6), while a missed
# tile or key moves it by far more.  dq/dk/dv: the plain backward runs in f32
# from the same bf16 inputs and is rounded to bf16 once; the kernel rounds dS
# and P to bf16 before their matmuls (the JAX kernels' rounding points),
# about 2^-8 relative per product, a few ulps of the largest gradient in all.
# Bound 2^-5 * max|plain| + BWD_ATOL elementwise and 2% of the plain
# gradient's norm + BWD_ATOL * sqrt(numel) over the whole tensor.  BWD_ATOL
# covers gradients that are zero in exact arithmetic (dq and dk at L = 1,
# where the softmax is constant): both sides then hold the f32 roundoff of
# dP - D, below 1e-6 at unit-scale inputs.
LSE_TOL = 1e-3
BWD_TOL = 2.0 ** -5
BWD_NORM_TOL = 2e-2
BWD_ATOL = 1e-5
# The int8 kernels against their plain versions (phase D).  The plain
# versions compute what the kernels compute, in the same order (the
# LayerNorm statistics included), so most results agree bit for bit; what
# may differ is a library function of a last ulp (tanh) and, through it, a
# code at a rounding tie.  Codes: |diff| <= 1 and at least 99% equal.
# Scales: rtol 1e-5 (a few f32 ulps; one flipped code moves none).  bf16
# outputs, row by row: one code step plus one bf16 ulp of the row's
# max|plain|, where a code step is what one activation code of the row
# changing by 1 moves an output by, at most s_x * 127 * max(w_s) (the int8
# weight itself is at most 127).
# (name, rows, edge rows): the serving shape, and rows on both sides of the
# 64-row tiles (K9's cluster tile, the K8/K10 consumer's) and the 128-row
# K8/K10 work tile
INT8_CASES = (("bs16 L1370", 16 * 1370, False), ("B*L 1", 1, False), ("B*L 17", 17, False),
              ("B*L 63", 63, False), ("B*L 64", 64, True), ("B*L 65", 65, True), ("B*L 127", 127, False),
              ("B*L 128", 128, True), ("B*L 129", 129, True), ("B*L 5483", 1370 * 4 + 3, True))
INT8_CODE_EQUAL = 0.99
INT8_SCALE_RTOL = 1e-5
# K5 against its plain version: K1's bound (the same kernel).
# K7: both sides round h, h1 and the GELU output to bf16 and their LayerNorm
# sums differ in order (a few f32 ulps, which can move h by one bf16 ulp);
# the bound is K6's, 2% of max|plain|.
K5_CASES = (("BH48 L1370 d64 (TP shard)", 48, 1370, 64, 1.0), ("BH48 L1370 d64 q*3", 48, 1370, 64, 3.0),
            ("BH80 L257 d32", 80, 257, 32, 1.0), ("BH4 L2917 d64", 4, 2917, 64, 1.0),
            ("BH3 L65 d16", 3, 65, 16, 1.0), ("BH1 L1 d128", 1, 1, 128, 1.0))
K7_TOL = 0.02
# K6 row counts: the serving shape, the 224px pseudo-label shape and both
# sides of the 128-row tile
K6_SHAPES = ((16, 1370), (3, 257), (1, 1), (1, 127), (1, 128), (1, 129))
# odd head counts on the packed layout at the head dims other than 64
ODD_HEADS_CASES = (("B2 L257 3x16", 2, 257, 3, 16), ("B2 L257 5x32", 2, 257, 5, 32),
                   ("B2 L1370 3x128", 2, 1370, 3, 128), ("B1 L65 1x128", 1, 65, 1, 128))
K7_ROWS = (("bs16 L1370", 16 * 1370), ("rows 1", 1), ("rows 17", 17), ("rows 65", 65),
           ("rows 5483", 1370 * 4 + 3))
SERVE_DIM = 768
NUM_HEADS = 12
MLP_DIM = 3072
# H100 SXM published dense peaks (the rates a bound is taken against)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_HBM = 3.35e12


class _Cfg(dict):
    """The attribute-style config node the feature extractor reads."""

    __getattr__ = dict.__getitem__


def _log(msg: str) -> None:
    print(msg, flush=True)


def _nan_like(x: torch.Tensor) -> torch.Tensor:
    """An output buffer pre-filled with NaN: a row the kernel fails to write
    stays NaN and fails the check."""
    return torch.full(x.shape, float("nan"), dtype=x.dtype, device=x.device)


def _check(name: str, got: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - ref.float()).abs().max().item()
    _log(f"  {name}: max_abs_err {err:.6g} (tol {tol:.4g}, max |plain| {ref.float().abs().max().item():.4g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} exceeds {tol}")
    return err


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
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


def _ab_ms(plain, kernel, iters: int):
    """Interleaved plain, kernel, kernel, plain -> (kernel ms, plain ms), each
    the mean of its two runs."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound(ops: float, nbytes: float, peak: float):
    """(bound ms, "operations" or "bytes"): the larger of ``ops`` at ``peak``
    and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _attention_bound(bh: int, l: int, d: int, matmuls: int = 2, tensors: int = 4, lse: bool = False):
    """Attention over ``bh`` heads of (l, d): ``matmuls`` products of
    2 * l^2 * d each per head, ``tensors`` bf16 (bh, l, d) tensors moved once
    (plus an f32 log-sum-exp row when ``lse``)."""
    nbytes = tensors * bh * l * d * 2 + (bh * l * 4 if lse else 0)
    return _bound(matmuls * 2.0 * bh * l * l * d, nbytes, PEAK_BF16)


def _sdpa_ms(q, k, v, scale, iters: int) -> float:
    """One ``scaled_dot_product_attention`` call on (B, H, L, d) views of the
    same tensors: the library yardstick, never used by the port."""
    import torch.nn.functional as F

    return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)


def _packed_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, L, 12 * 64) -> a (B, 12, L, 64) view of the same memory."""
    b, l, _ = x.shape
    return x.view(b, l, NUM_HEADS, SERVE_DIM // NUM_HEADS).transpose(1, 2)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
         f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("tf32: matmul off, cudnn off")
    return smi


def phase_build() -> None:
    from ucod_dpl_tpu_torch.ops import _build

    path, secs = _build.build()
    _build.kernels()
    _log(f"build: {secs:.2f} s -> {path}")


def phase_k1(gen, dev) -> float:
    from ucod_dpl_tpu_torch.ops.attention import packed_attention, packed_attention_reference

    _log("K1 packed attention vs plain (bf16):")
    worst = 0.0
    for name, b, l, q_scale, tail in (
        ("bs16 L1370", 16, 1370, 1.0, False),
        ("bs16 L257", 16, 257, 1.0, False),
        ("bs4 L2917", 4, 2917, 1.0, False),
        ("bs16 L1370 q*3", 16, 1370, 3.0, False),
        ("bs1 L1370 NaN rows past L", 1, 1370, 1.0, True),
        # the last 128-key tile is mostly padding: a missing key mask or a
        # wrong tail tile moves the output by a large share
        ("bs16 L65", 16, 65, 1.0, False),
        ("bs16 L1", 16, 1, 1.0, False),
    ):
        rows = l + 38 if tail else l
        qkv = []
        for s in (q_scale, 1.0, 1.0):
            x = torch.randn(b, rows, SERVE_DIM, generator=gen, device=dev).mul_(s).to(torch.bfloat16)
            x[:, l:] = float("nan")
            qkv.append(x[:, :l])  # contiguous for b == 1
        out = packed_attention(*qkv, NUM_HEADS, 0.125, out=_nan_like(qkv[0]))
        torch.cuda.synchronize()
        ref = packed_attention_reference(*qkv, NUM_HEADS, 0.125)
        worst = max(worst, _check(name, out, ref, K1_TOL * ref.float().abs().max().item()))
    return worst


def _nan_tailed_shape(gen, dev, shape, scale=1.0):
    """A contiguous bf16 normal tensor of ``shape`` whose memory is followed by
    64 rows of NaN: a kernel that reads a row past the last one reads NaN."""
    n = int(np.prod(shape))
    buf = torch.full((n + 64 * shape[-1],), float("nan"), dtype=torch.bfloat16, device=dev)
    x = buf[:n].view(shape)
    x.copy_(torch.randn(shape, generator=gen, device=dev).mul_(scale))
    return x


def _nan_tailed(gen, dev, b, l, scale=1.0):
    """A (b, l, 768) :func:`_nan_tailed_shape` tensor."""
    return _nan_tailed_shape(gen, dev, (b, l, SERVE_DIM), scale)


def _check_grad(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """The backward's bounds (BWD_TOL, BWD_NORM_TOL, BWD_ATOL above)."""
    got, ref = got.float(), ref.float()
    err = _check(name, got, ref, BWD_TOL * ref.abs().max().item() + BWD_ATOL)
    diff, norm = (got - ref).norm().item(), ref.norm().item()
    bound = BWD_NORM_TOL * norm + BWD_ATOL * ref.numel() ** 0.5
    _log(f"    norm of the error {diff:.6g}, {diff / max(norm, 1e-30):.6g} of the plain norm (bound {bound:.6g})")
    if not diff <= bound:
        raise AssertionError(f"{name}: error norm {diff} exceeds {bound}")
    return err


def phase_attention_grad(gen, dev) -> dict:
    """Phase A: the forward with log-sum-exp and the backward against their
    plain versions, bf16, every output pre-filled with NaN, NaN in memory past
    the last batch element's row L-1 of every input."""
    from ucod_dpl_tpu_torch.ops.attention import (
        packed_attention_bwd,
        packed_attention_bwd_reference,
        packed_attention_fwd_lse,
        packed_attention_fwd_lse_reference,
    )

    _log("attention forward + LSE and backward vs plain (bf16):")
    worst = {"fwd_lse": 0.0, "bwd": 0.0}
    for name, b, l, q_scale in (
        ("bs16 L1370", 16, 1370, 1.0),
        ("bs4 L2917", 4, 2917, 1.0),
        ("bs16 L1370 q*3", 16, 1370, 3.0),
        ("bs16 L257", 16, 257, 1.0),
        ("bs16 L65", 16, 65, 1.0),
        ("bs16 L1", 16, 1, 1.0),
        ("bs1 L1370", 1, 1370, 1.0),
    ):
        q, k, v, do = (_nan_tailed(gen, dev, b, l, s) for s in (q_scale, 1.0, 1.0, 1.0))
        o = _nan_tailed(gen, dev, b, l)
        lse = torch.full((b, NUM_HEADS, l), float("nan"), device=dev)
        packed_attention_fwd_lse(q, k, v, NUM_HEADS, 0.125, out=(o, lse))
        torch.cuda.synchronize()
        o_ref, lse_ref = packed_attention_fwd_lse_reference(q, k, v, NUM_HEADS, 0.125)
        worst["fwd_lse"] = max(worst["fwd_lse"],
                               _check(f"{name} o", o, o_ref, K1_TOL * o_ref.float().abs().max().item()))
        _check(f"{name} lse", lse, lse_ref, LSE_TOL)
        grads = packed_attention_bwd(q, k, v, o, do, lse, NUM_HEADS, 0.125,
                                     out=tuple(_nan_like(q) for _ in range(3)))
        torch.cuda.synchronize()
        refs = packed_attention_bwd_reference(q, k, v, o, do, lse, NUM_HEADS, 0.125)
        for which, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            worst["bwd"] = max(worst["bwd"], _check_grad(f"{name} {which}", got, ref))
        del refs, grads
    return worst


def _lnqkv_inputs(gen, dev, b, l):
    """bf16 x and weights, f32 LayerNorm params and biases: the dtypes the
    serving backbone holds (``cast_params``)."""
    d = SERVE_DIM
    x = torch.randn(b, l, d, generator=gen, device=dev).to(torch.bfloat16)
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device=dev),
            "bias": 0.1 * torch.randn(d, generator=gen, device=dev)}
    lins = [{"w": (torch.randn(d, d, generator=gen, device=dev) / d ** 0.5).to(torch.bfloat16),
             "b": 0.1 * torch.randn(d, generator=gen, device=dev)} for _ in range(3)]
    return x, norm, lins


def phase_k6(gen, dev) -> float:
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_qkv, layernorm_qkv_reference

    _log("K6 LayerNorm + q/k/v vs plain (bf16):")
    worst = 0.0
    for b, l in K6_SHAPES:
        x, norm, lins = _lnqkv_inputs(gen, dev, b, l)
        x = _nan_tailed(gen, dev, b, l).copy_(x)
        outs = layernorm_qkv(x, norm, *lins, 1e-6, out=tuple(_nan_like(x) for _ in range(3)))
        torch.cuda.synchronize()
        refs = layernorm_qkv_reference(x, norm, *lins, 1e-6)
        for which, o, r in zip("qkv", outs, refs):
            tol = K6_TOL * r.float().abs().max().item()
            worst = max(worst, _check(f"bs{b} L{l} {which}", o, r, tol))
    return worst


def _serving_model(seed: int, dev, quantize=None):
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder

    fe_cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = FeatureExtractor(fe_cfg, device=dev, seed=seed, strict=False, quantize=quantize)
    decoder = init_rev_decoder(seed + 1, SERVE_DIM)
    return fe, decoder


def phase_serving(fe, decoder, seed: int) -> dict:
    from ucod_dpl_tpu_torch.ops.attention import packed_attention
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_qkv
    from ucod_dpl_tpu_torch.serving import Predictor

    depth = fe.config.num_layers
    predictor = Predictor(fe, decoder, image_size=(518, 518), feature_size=68, max_batch=16)
    rng = np.random.default_rng(seed + 2)
    _log(f"serving: dinov2-base {fe.config.hidden_size}-wide x{depth} layers, 518px, "
         f"{fe.compute_dtype}, max_batch 16")
    for fn in _kernel_wrappers().values():  # every count, the training kernels' too
        fn.launches = 0
    for n, soft in ((16, False), (5, False), (1, False), (5, True)):
        before = (packed_attention.launches, layernorm_qkv.launches)
        images = rng.standard_normal((n, 518, 518, 3)).astype(np.float32)
        t0 = time.perf_counter()
        masks = predictor.predict(list(images), soft=soft)
        secs = time.perf_counter() - t0
        delta = (packed_attention.launches - before[0], layernorm_qkv.launches - before[1])
        if len(masks) != n or any(m.shape != (518, 518) for m in masks):
            raise AssertionError(f"request of {n}: wrong mask count or shape")
        stack = np.stack(masks)
        if soft:
            if not (np.isfinite(stack).all() and stack.min() >= 0 and stack.max() <= 1):
                raise AssertionError("soft masks are not finite probabilities")
        elif not np.isin(stack, (0.0, 1.0)).all():
            raise AssertionError("masks are not in {0, 1}")
        if delta != (depth - 1, depth - 1):
            raise AssertionError(f"request of {n}: K1/K6 launched {delta}, expected {depth - 1} each")
        _log(f"  request of {n} (bucket {predictor._bucket(n)}, soft={soft}): {secs:.3f} s "
             f"host clock, foreground share {stack.mean():.4f}, K1/K6 launches {delta}")
    launches = {k: fn.launches for k, fn in _kernel_wrappers().items()}
    if launches["fwd_lse"] or launches["bwd"] or launches["K5"] or launches["K7"]:
        raise AssertionError(f"serving launched kernels off its path: {launches}")
    return launches


# The UCOD-DPL_dinov2 stage-1 configuration (configs/uscod/UCOD-DPL_dinov2.py
# over configs/__base__/newbase.py) with LoRA on: rank 2, alpha 4, lr 1e-4,
# no remat (or ``remat``).
def _train_cfg(remat: str = "none"):
    return _Cfg(
        model_cfg=_Cfg(feature_size=68, ema_weight=0.99,
                       lora=_Cfg(rank=2, alpha=4.0, lr=1e-4, remat=remat)),
        train_cfg=_Cfg(max_epoch=25, start_finetune=-5, merge_method="dis", lr0=2e-4, dis_lr0=1e-3,
                       step_lr_gamma=0.95, step_lr_size=25, dis_step_lr_gamma=0.95, dis_step_lr_size=25),
    )


def _lora_setup(seed: int, dev, batch: int):
    """A full-width dinov2-base with float32 q/k/v masters (seeded random
    weights), fresh decoder/EMA/discriminator state and adapters, and seeded
    518px pixels and 68x68 pseudo-labels of ``batch`` images."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.engine.train_step import init_train_state, make_optimizer
    from ucod_dpl_tpu_torch.models.convert import tree_leaves, tree_map
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder
    from ucod_dpl_tpu_torch.models.discriminator import init_discriminator
    from ucod_dpl_tpu_torch.models.lora import init_lora

    cfg = _train_cfg()
    fe_cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = FeatureExtractor(fe_cfg, device=dev, seed=seed, strict=False, qkv_masters=True)
    state = init_train_state(init_rev_decoder(seed + 1, SERVE_DIM), init_rev_decoder(seed + 4, SERVE_DIM),
                             *init_discriminator(seed + 5, 68, SERVE_DIM, False), cfg.train_cfg, dev)
    lora = tree_map(lambda t: t.requires_grad_(True), init_lora(seed + 3, fe.params, rank=2))
    lora_opt = make_optimizer(tree_leaves(lora), cfg.model_cfg.lora.lr, 0.95, 25)
    rng = np.random.default_rng(seed + 6)
    pixels = torch.from_numpy(rng.standard_normal((batch, 518, 518, 3)).astype(np.float32)).to(dev)
    labels = torch.from_numpy((rng.random((batch, 68, 68, 1)) > 0.5).astype(np.float32)).to(dev)
    return cfg, fe, state, lora, lora_opt, pixels, labels


def _kernel_wrappers():
    """The bf16 wrappers whose ``launches`` count the main paths' kernel
    launches."""
    from ucod_dpl_tpu_torch.ops.attention import (
        heads_attention,
        packed_attention,
        packed_attention_bwd,
        packed_attention_fwd_lse,
    )
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_fc1_gelu, layernorm_qkv

    return {"K1": packed_attention, "K5": heads_attention, "K6": layernorm_qkv, "K7": layernorm_fc1_gelu,
            "fwd_lse": packed_attention_fwd_lse, "bwd": packed_attention_bwd}


def phase_lora(seed: int, dev) -> dict:
    """Phase B: three LoRA joint steps at full width, bs16 518px bf16, remat
    none, through the forward-LSE and backward kernels, then one
    discriminator step on the adapted backbone's features."""
    from ucod_dpl_tpu_torch.engine.train_step import make_discriminator_step, make_lora_train_step
    from ucod_dpl_tpu_torch.models.lora import lora_forward

    cfg, fe, state, lora, lora_opt, pixels, labels = _lora_setup(seed, dev, 16)
    step = make_lora_train_step(cfg, fe.config, torch.bfloat16)
    depth = fe.config.num_layers
    _log(f"LoRA joint step: dinov2-base {fe.config.hidden_size}-wide x{depth} layers, bs16 518px bf16, "
         f"rank 2, alpha 4, remat none, feature_size 68, merge dis")
    counts = _kernel_wrappers()
    for fn in counts.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        before = {k: fn.launches for k, fn in counts.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = step(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)
        loss = aux["loss"].item()
        secs = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in counts.items()}
        b_norm = torch.sqrt(sum(e["b"].float().square().sum() for layer in lora for e in layer.values())).item()
        _log(f"  step {i + 1}: loss {loss:.6f}, lora grad norm {aux['lora_grad_norm'].item():.6g}, "
             f"adapter B-norm {b_norm:.6g}, {secs:.3f} s host clock, launches {delta}")
        if not np.isfinite(loss):
            raise AssertionError(f"step {i + 1}: non-finite loss {loss}")
        if not b_norm > 0:
            raise AssertionError(f"step {i + 1}: the adapters' B did not move")
        if delta != {"K1": 0, "K5": 0, "K6": 0, "K7": 0, "fwd_lse": depth - 1, "bwd": depth - 1}:
            raise AssertionError(f"step {i + 1}: launches {delta}, expected {depth - 1} forward-LSE and "
                                 f"backward launches and no K1/K6")
    launches = {k: fn.launches for k, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    _log(f"  peak device memory over the three steps {peak:.3f} GiB")

    with torch.no_grad():
        feats = lora_forward(fe.params, lora, pixels, fe.config, compute_dtype=torch.bfloat16)["key_features"]
    dis_loss = make_discriminator_step(cfg)(state, feats.float(), labels)["dis_train_loss"].item()
    _log(f"  discriminator step on the adapted features: loss {dis_loss:.6f}")
    if not np.isfinite(dis_loss):
        raise AssertionError(f"discriminator step: non-finite loss {dis_loss}")
    return {"launches": launches, "peak_gib": peak, "state": (cfg, fe, state, lora, lora_opt, pixels, labels)}


def _grads(loss_fn, state, lora, fe, pixels, labels):
    """The decoder's and the adapters' gradients of one loss, each group
    flattened into one f32 vector."""
    from ucod_dpl_tpu_torch.models.convert import tree_leaves

    groups = (tree_leaves(state.decoder), tree_leaves(lora))
    loss, _ = loss_fn(state, lora, fe.params, pixels, labels, 2.0, 1.0)
    grads = iter(torch.autograd.grad(loss, groups[0] + groups[1], allow_unused=True))
    return [torch.cat([(torch.zeros_like(t) if g is None else g).float().flatten()
                       for g, t in zip(grads, leaves)]) for leaves in groups]


def phase_lora_grads(seed: int, dev) -> float:
    """At the third LoRA step (B != 0, so the A-grads are live), bs4 518px:
    the global-vector norm-relative difference of the decoder + LoRA grads,
    kernel path vs plain path on the same weights.  Bound 0.1, the JAX
    package's own on-chip bound (scripts/tpu_selfcheck.py check 6: per-leaf
    bounds fail on the cancellation-prone key-bias grad).  The adapters'
    gradients alone are held to the same bound: the decoder's gradients do
    not pass through the attention backward and dominate the global norm."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step

    cfg, fe, state, lora, lora_opt, pixels, labels = _lora_setup(seed + 10, dev, 4)
    step = make_lora_train_step(cfg, fe.config, torch.bfloat16)
    for _ in range(2):
        step(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)
    g_kernel = _grads(step.loss_fn, state, lora, fe, pixels, labels)
    plain = make_lora_train_step(cfg, fe.config, torch.bfloat16, plain=True)
    g_plain = _grads(plain.loss_fn, state, lora, fe, pixels, labels)
    rels = {}
    for name, gk, gp in (("decoder + LoRA", torch.cat(g_kernel), torch.cat(g_plain)),
                         ("LoRA alone", g_kernel[1], g_plain[1])):
        rels[name] = ((gk - gp).norm() / gp.norm()).item()
        _log(f"LoRA step 3 grads, bs4 518px bf16, kernels vs plain, {name}: norm-relative difference "
             f"{rels[name]:.6g} (bound 0.1; |g| {gp.norm().item():.6g}, {gp.numel()} values)")
        if not (np.isfinite(rels[name]) and rels[name] <= 0.1):
            raise AssertionError(f"LoRA grads ({name}): kernel vs plain {rels[name]} exceeds 0.1")
    return rels["decoder + LoRA"]


def phase_composed(fe, decoder, seed: int) -> None:
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.models.convert import params_to
    from ucod_dpl_tpu_torch.models.dba import fg_logits_live

    dev = fe.device
    dec = params_to(decoder, dev)
    # the same seeded weights, kept in float32 for the reference
    f32_params = FeatureExtractor(fe.fe_cfg, device=dev, compute_dtype=torch.float32,
                                  seed=seed, strict=False).params
    px = torch.from_numpy(
        np.random.default_rng(seed + 3).standard_normal((4, 518, 518, 3)).astype(np.float32)
    ).to(dev)
    with torch.inference_mode():
        def run(params, dtype, plain):
            fg, _, _ = fg_logits_live(params, dec, px, fe.config, compute_dtype=dtype, size=68, plain=plain)
            return fg.float()

        ref = run(f32_params, torch.float32, True)
        err_kernel = (run(fe.params, torch.bfloat16, False) - ref).abs().max().item()
        err_plain = (run(fe.params, torch.bfloat16, True) - ref).abs().max().item()
    bound = 1.5 * err_plain + 1e-3
    _log(f"composed fg_logits_live bs4 518px vs f32 plain: kernel bf16 max_abs_err {err_kernel:.6g}, "
         f"plain bf16 {err_plain:.6g}, bound {bound:.6g} (max |f32| {ref.abs().max().item():.4g})")
    if not (np.isfinite(err_kernel) and err_kernel <= bound):
        raise AssertionError(f"kernel path error {err_kernel} exceeds {bound}")


def phase_timing(fe, decoder, gen) -> dict:
    from ucod_dpl_tpu_torch.models.convert import params_to
    from ucod_dpl_tpu_torch.models.dba import fg_logits_live
    from ucod_dpl_tpu_torch.ops.attention import packed_attention, packed_attention_reference
    from ucod_dpl_tpu_torch.ops.fused_layers import layer_norm, layernorm_qkv, layernorm_qkv_reference

    dev = fe.device
    _log("timing (CUDA events, interleaved plain/kernel/kernel/plain, bf16):")
    q, k, v = (torch.randn(16, 1370, SERVE_DIM, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    k1_ms, k1_plain = _ab_ms(lambda: packed_attention_reference(q, k, v, NUM_HEADS, 0.125),
                             lambda: packed_attention(q, k, v, NUM_HEADS, 0.125), 20)
    sdpa_ms = _sdpa_ms(*(_packed_heads(x) for x in (q, k, v)), 0.125, 20)
    _log(f"  K1 bs16 L1370 12x64: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, "
         f"scaled_dot_product_attention {sdpa_ms:.4f} ms")
    x, norm, lins = _lnqkv_inputs(gen, dev, 16, 1370)
    k6_ms, k6_plain = _ab_ms(lambda: layernorm_qkv_reference(x, norm, *lins, 1e-6),
                             lambda: layernorm_qkv(x, norm, *lins, 1e-6), 20)
    # the GEMM alone: one cuBLAS product of the normalised h with the
    # concatenated (2304, 768) weight (a yardstick; K6 computes more)
    h = layer_norm(x, norm, 1e-6)
    w_cat = torch.cat([lin["w"] for lin in lins])
    gemm_ms = _time_ms(lambda: torch.nn.functional.linear(h, w_cat), 20)
    _log(f"  K6 bs16 L1370 768->3x768: kernel {k6_ms:.4f} ms, plain {k6_plain:.4f} ms, "
         f"cuBLAS GEMM alone (h @ W_qkv^T) {gemm_ms:.4f} ms")

    dec = params_to(decoder, dev)
    px = torch.randn(16, 518, 518, 3, generator=gen, device=dev)
    with torch.inference_mode():
        def fwd(plain):
            return lambda: fg_logits_live(fe.params, dec, px, fe.config, compute_dtype=torch.bfloat16,
                                          size=68, plain=plain)

        fwd_ms, fwd_plain = _ab_ms(fwd(True), fwd(False), 5)
    _log(f"  fg_logits_live bs16 518px bf16: kernels {fwd_ms:.3f} ms = {16e3 / fwd_ms:.2f} img/s; "
         f"plain {fwd_plain:.3f} ms = {16e3 / fwd_plain:.2f} img/s")
    _trace(fwd(False), "fg_logits_live bs16 518px bf16")
    return {"K1": (k1_ms, k1_plain), "K6": (k6_ms, k6_plain), "K6_gemm_alone": gemm_ms, "sdpa_fwd": sdpa_ms,
            "fg_logits_live_img_per_s": 16e3 / fwd_ms, "fg_logits_live_plain_img_per_s": 16e3 / fwd_plain}


def phase_train_timing(lora_run: dict, gen) -> dict:
    """The differentiated attention and the LoRA step, kernels vs plain, CUDA
    events, interleaved."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step
    from ucod_dpl_tpu_torch.ops.attention import (
        packed_attention_bwd,
        packed_attention_bwd_reference,
        packed_attention_diff,
        packed_attention_fwd_lse,
        packed_attention_fwd_lse_reference,
        packed_attention_reference,
    )

    cfg, fe, state, lora, lora_opt, pixels, labels = lora_run["state"]
    dev = pixels.device
    _log("training timing (CUDA events, interleaved plain/kernel/kernel/plain, bf16):")
    out = {}
    for b, l in ((16, 1370), (4, 2917)):
        q, k, v, do = (torch.randn(b, l, SERVE_DIM, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def fwd_bwd(attn):
            return lambda: torch.autograd.grad(attn(*leaves, NUM_HEADS, 0.125), leaves, do)

        ms, plain_ms = _ab_ms(fwd_bwd(packed_attention_reference), fwd_bwd(packed_attention_diff), 10)
        _log(f"  attention forward + backward bs{b} L{l}: kernels {ms:.4f} ms, plain autograd {plain_ms:.4f} ms")
        out[f"fwd_bwd_bs{b}_L{l}"] = (ms, plain_ms)
        if b == 16:
            ms, plain_ms = _ab_ms(lambda: packed_attention_fwd_lse_reference(q, k, v, NUM_HEADS, 0.125),
                                  lambda: packed_attention_fwd_lse(q, k, v, NUM_HEADS, 0.125), 20)
            _log(f"  forward + LSE bs16 L1370: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            out["fwd_lse"] = (ms, plain_ms)
            o, lse = packed_attention_fwd_lse(q, k, v, NUM_HEADS, 0.125)
            ms, plain_ms = _ab_ms(
                lambda: packed_attention_bwd_reference(q, k, v, o, do, lse, NUM_HEADS, 0.125),
                lambda: packed_attention_bwd(q, k, v, o, do, lse, NUM_HEADS, 0.125), 20)
            # the library yardstick: the backward of one scaled_dot_product_attention
            # call on (B, H, L, d) views of the same q/k/v, from its saved forward
            heads = [_packed_heads(x).detach().requires_grad_(True) for x in (q, k, v)]
            o_sdpa = torch.nn.functional.scaled_dot_product_attention(*heads, scale=0.125)
            sdpa_bwd = _time_ms(lambda: torch.autograd.grad(o_sdpa, heads, _packed_heads(do), retain_graph=True), 20)
            _log(f"  backward bs16 L1370: kernels {ms:.4f} ms, plain (f32 flash algebra) {plain_ms:.4f} ms, "
                 f"scaled_dot_product_attention backward {sdpa_bwd:.4f} ms")
            out["bwd"] = (ms, plain_ms)
            out["sdpa_bwd"] = sdpa_bwd
            del heads, o_sdpa
        del q, k, v, do, leaves

    def run(step):
        return lambda: step(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)

    kernel_step = run(make_lora_train_step(cfg, fe.config, torch.bfloat16))
    plain_step = run(make_lora_train_step(cfg, fe.config, torch.bfloat16, plain=True))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        plain_step()
        torch.cuda.synchronize()
        fits = True
    except torch.cuda.OutOfMemoryError as err:
        fits = False
        _log(f"  plain LoRA step bs16 does not fit: peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
             f"allocated before: {str(err).splitlines()[0]}")
    torch.cuda.empty_cache()
    if fits:
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        ms, plain_ms = _ab_ms(plain_step, kernel_step, 3)
        _log(f"  LoRA step bs16 518px: kernels {ms:.3f} ms, plain {plain_ms:.3f} ms "
             f"(plain peak {plain_peak:.3f} GiB, kernels {lora_run['peak_gib']:.3f} GiB)")
    else:
        ms, plain_ms = _time_ms(kernel_step, 5, warmup=1), None
        _log(f"  LoRA step bs16 518px: kernels {ms:.3f} ms")
    out["lora_step"] = (ms, plain_ms)
    # remat "layer": each layer's forward, attention included, runs again in
    # the backward, so each of the 4 steps timed launches 2 x 11 forward-LSE
    layer_step = run(make_lora_train_step(_train_cfg("layer"), fe.config, torch.bfloat16))
    torch.cuda.reset_peak_memory_stats()
    fwd_lse = _kernel_wrappers()["fwd_lse"]
    before = fwd_lse.launches
    layer_ms = _time_ms(layer_step, 3, warmup=1)
    recomputed = fwd_lse.launches - before
    out["lora_step_remat_layer"] = layer_ms
    _log(f"  LoRA step bs16 518px, remat layer: kernels {layer_ms:.3f} ms, "
         f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, {recomputed} forward-LSE launches in 4 steps")
    if recomputed != 4 * 2 * (fe.config.num_layers - 1):
        raise AssertionError(f"remat layer: {recomputed} forward-LSE launches in 4 steps, expected "
                             f"{4 * 2 * (fe.config.num_layers - 1)}")
    _trace(kernel_step, "LoRA step bs16 518px bf16, remat none", inference=False)
    return out


def _int8_wrappers():
    """The int8 kernels' wrappers, by kernel id."""
    from ucod_dpl_tpu_torch.ops import fused_layers as FL

    return {"K8": FL.layernorm_qkv_w8a8, "K9": FL.layernorm_fc1_gelu_w8a8, "K10": FL.dense_quant_w8a8,
            "K11": FL.layernorm_mlp_w8a8}


def _int8_layer(gen, dev, with_f32=False):
    """One layer's LayerNorm params (f32) and int8 q/k/v/out/fc1/fc2,
    quantized from seeded f32 weights at the serving widths; ``with_f32``:
    also those f32 linears."""
    from ucod_dpl_tpu_torch.ops.quant import quantize_linear

    def lin(d_in, d_out):
        return {"w": torch.randn(d_out, d_in, generator=gen, device=dev) / d_in ** 0.5,
                "b": 0.1 * torch.randn(d_out, generator=gen, device=dev)}

    d, f = SERVE_DIM, MLP_DIM
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device=dev),
            "bias": 0.1 * torch.randn(d, generator=gen, device=dev)}
    f32 = {name: lin(d, d) for name in ("q", "k", "v", "out")}
    f32["fc1"], f32["fc2"] = lin(d, f), lin(f, d)
    q8 = {name: quantize_linear(p) for name, p in f32.items()}
    return (norm, q8, f32) if with_f32 else (norm, q8)


def _int8_input(gen, dev, rows, edge):
    """A bf16 (1, rows, 768) input whose memory is followed by 64 rows of
    NaN.  ``edge``: rows spread over six decades of scale, row 0 all zero,
    row 1 constant."""
    x = _nan_tailed(gen, dev, 1, rows)
    if edge:
        x.mul_(torch.logspace(-3, 3, rows, device=dev).to(torch.bfloat16)[:, None])
        x[0, 0] = 0.0
        x[0, 1] = 0.5
    return x


def int8_out_bound(ref: torch.Tensor, s_x: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """Per row: one code step (s_x * 127 * max w_s) plus one bf16 ulp of the
    row's max|plain|."""
    rowmax = ref.float().abs().amax(dim=-1, keepdim=True)
    ulp = torch.where(rowmax > 0, torch.exp2(torch.floor(torch.log2(rowmax)) - 7), torch.zeros_like(rowmax))
    return s_x * 127 * w_s.max() + ulp


def _check_int8_out(name, got, ref, s_x, w_s) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got.float() - ref.float()).abs()
    ratio = (diff / int8_out_bound(ref, s_x, w_s)).max().item()
    err = diff.max().item()
    _log(f"  {name}: max_abs_err {err:.6g} (max |plain| {ref.float().abs().max().item():.4g}), "
         f"{ratio:.4g} of the row bound; equal to plain: {(got == ref).float().mean().item():.6f}")
    if not ratio <= 1:
        raise AssertionError(f"{name}: error {ratio} times its row bound")
    return err


def _check_codes(name, codes, scales, ref_codes, ref_scales) -> float:
    """K9's bounds; returns the largest difference of the dequantized values."""
    if not torch.isfinite(scales).all():
        raise AssertionError(f"{name}: non-finite scales")
    diff = (codes.int() - ref_codes.int()).abs()
    equal = (diff == 0).float().mean().item()
    rel = ((scales - ref_scales).abs() / ref_scales.abs()).max().item()
    deq = (codes.float() * scales - ref_codes.float() * ref_scales).abs().max().item()
    _log(f"  {name}: codes max |diff| {diff.max().item()}, equal {equal:.6f}; scales max rel diff {rel:.3g}; "
         f"dequantized max_abs_err {deq:.6g}")
    if not (diff.max().item() <= 1 and equal >= INT8_CODE_EQUAL and rel <= INT8_SCALE_RTOL):
        raise AssertionError(f"{name}: codes or scales out of bounds")
    return deq


def phase_int8_kernels(gen, dev) -> dict:
    """Phase D: K8-K11 against their plain versions."""
    from ucod_dpl_tpu_torch.ops import fused_layers as FL
    from ucod_dpl_tpu_torch.ops.quant import dense_w8a8_pre, quantize_act

    norm, q8 = _int8_layer(gen, dev)
    eps = 1e-6
    _log("int8 kernels K8-K11 vs plain (bf16 activations, int8 weights):")
    worst = {k: 0.0 for k in ("K8", "K9", "K10", "K11")}
    for name, rows, edge in INT8_CASES:
        x = _int8_input(gen, dev, rows, edge)
        h_s = quantize_act(FL._layernorm_f32(x, norm, eps))[1]
        outs = FL.layernorm_qkv_w8a8(x, norm, q8["q"], q8["k"], q8["v"], eps,
                                     out=tuple(_nan_like(x) for _ in range(3)))
        torch.cuda.synchronize()
        refs = FL.layernorm_qkv_w8a8_reference(x, norm, q8["q"], q8["k"], q8["v"], eps)
        for which, o, r in zip("qkv", outs, refs):
            worst["K8"] = max(worst["K8"], _check_int8_out(f"K8 {name} {which}", o, r, h_s, q8[which]["w_s"]))
        got = FL.dense_quant_w8a8(x, q8["out"], torch.bfloat16, out=_nan_like(x))
        torch.cuda.synchronize()
        worst["K10"] = max(worst["K10"], _check_int8_out(
            f"K10 {name}", got, FL.dense_quant_w8a8_reference(x, q8["out"], torch.bfloat16),
            quantize_act(x)[1], q8["out"]["w_s"]))
        codes = torch.full((1, rows, MLP_DIM), -128, dtype=torch.int8, device=dev)
        scales = torch.full((1, rows, 1), float("nan"), device=dev)
        FL.layernorm_fc1_gelu_w8a8(x, norm, q8["fc1"], eps, out=(codes, scales))
        torch.cuda.synchronize()
        ref_codes, ref_scales = FL.layernorm_fc1_gelu_w8a8_reference(x, norm, q8["fc1"], eps)
        worst["K9"] = max(worst["K9"], _check_codes(f"K9 {name}", codes, scales, ref_codes, ref_scales))
        got = FL.layernorm_mlp_w8a8(x, norm, q8["fc1"], q8["fc2"], eps, out=_nan_like(x))
        torch.cuda.synchronize()
        ref = FL.layernorm_mlp_w8a8_reference(x, norm, q8["fc1"], q8["fc2"], eps)
        worst["K11"] = max(worst["K11"], _check_int8_out(f"K11 {name}", got, ref, ref_scales, q8["fc2"]["w_s"]))
        split = dense_w8a8_pre(codes, scales, q8["fc2"], torch.bfloat16)
        _log(f"  K11 {name} vs the split kernel path (K9, dense_w8a8_pre): equal {(got == split).float().mean().item():.6f}")
        if not torch.equal(got, split):
            raise AssertionError(f"K11 {name}: not bit-equal to the split kernel path")
        del outs, refs, codes, ref_codes
    return worst


def phase_int8_serving(fe8, decoder, seed: int) -> dict:
    """Phase E: ``Predictor(quantize="int8")`` requests, then one whole-MLP
    forward, each with every count set to 0 just before it."""
    from ucod_dpl_tpu_torch.models.convert import params_to
    from ucod_dpl_tpu_torch.models.dba import fg_logits_live
    from ucod_dpl_tpu_torch.serving import Predictor

    n = fe8.config.num_layers - 1
    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    predictor = Predictor(fe8, decoder, image_size=(518, 518), feature_size=68, max_batch=16)
    if predictor.quantize != "int8" or predictor._qparams is not fe8._qparams:
        raise AssertionError("an int8 extractor did not opt the Predictor in")
    rng = np.random.default_rng(seed + 7)
    _log(f"int8 serving: dinov2-base {fe8.config.hidden_size}-wide x{n + 1} layers, 518px, "
         f"{fe8.compute_dtype} + int8 linears, max_batch 16")
    for fn in counts.values():
        fn.launches = 0
    want = {"K1": n, "K5": 0, "K6": 0, "K7": 0, "fwd_lse": 0, "bwd": 0, "K8": n, "K9": n, "K10": n, "K11": 0}
    for size in (16, 5, 1):
        before = {k: fn.launches for k, fn in counts.items()}
        images = rng.standard_normal((size, 518, 518, 3)).astype(np.float32)
        t0 = time.perf_counter()
        masks = predictor.predict(list(images))
        secs = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in counts.items()}
        stack = np.stack(masks)
        if stack.shape != (size, 518, 518) or not np.isin(stack, (0.0, 1.0)).all():
            raise AssertionError(f"int8 request of {size}: wrong masks")
        if delta != want:
            raise AssertionError(f"int8 request of {size}: launches {delta}, expected {want}")
        _log(f"  request of {size}: {secs:.3f} s host clock, foreground share {stack.mean():.4f}, launches {delta}")
    launches = {k: fn.launches for k, fn in counts.items()}

    for fn in counts.values():
        fn.launches = 0
    px = torch.from_numpy(rng.standard_normal((2, 518, 518, 3)).astype(np.float32)).to(fe8.device)
    with torch.inference_mode():
        fg, _, _ = fg_logits_live(fe8.params, params_to(decoder, fe8.device), px, fe8.config,
                                  compute_dtype=torch.bfloat16, size=68, quant=fe8._qparams, int8_mlp="whole")
    whole = {k: fn.launches for k, fn in counts.items()}
    _log(f"  int8_mlp='whole' forward bs2: launches {whole}")
    if not torch.isfinite(fg).all():
        raise AssertionError("whole-MLP forward: non-finite logits")
    if whole != {**want, "K9": 0, "K11": n}:
        raise AssertionError(f"whole-MLP forward: launches {whole}, expected K11 {n} and no K9")
    launches["K11"] = whole["K11"]
    return launches


def phase_int8_composed(fe8, decoder, seed: int) -> float:
    """Phase F: bs4 518px against the float32 plain path; returns the int8
    kernel path's error."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.models.convert import params_to
    from ucod_dpl_tpu_torch.models.dba import fg_logits_live

    dev = fe8.device
    dec = params_to(decoder, dev)
    f32_params = FeatureExtractor(fe8.fe_cfg, device=dev, compute_dtype=torch.float32, seed=seed,
                                  strict=False).params
    px = torch.from_numpy(np.random.default_rng(seed + 8).standard_normal((4, 518, 518, 3))
                          .astype(np.float32)).to(dev)
    with torch.inference_mode():
        def run(params, dtype, plain, quant):
            fg, _, _ = fg_logits_live(params, dec, px, fe8.config, compute_dtype=dtype, size=68, plain=plain,
                                      quant=quant)
            return fg.float()

        ref = run(f32_params, torch.float32, True, None)
        got = run(fe8.params, torch.bfloat16, False, fe8._qparams)
        err = (got - ref).abs().max().item()
        err_plain = (run(fe8.params, torch.bfloat16, True, fe8._qparams) - ref).abs().max().item()
    agree = ((got > 0) == (ref > 0)).float().mean().item()
    bound = 1.5 * err_plain + 1e-3
    _log(f"composed int8 fg_logits_live bs4 518px vs f32 plain: kernels max_abs_err {err:.6g}, int8 plain "
         f"{err_plain:.6g}, bound {bound:.6g}; masks agree with f32 on {agree:.6f} (bound 0.9; "
         f"max |f32| {ref.abs().max().item():.4g})")
    if not (np.isfinite(err) and err <= bound):
        raise AssertionError(f"int8 kernel path error {err} exceeds {bound}")
    if not agree > 0.9:
        raise AssertionError(f"int8 masks agree with f32 on {agree} of the pixels")
    return err


def phase_int8_timing(fe8, decoder, gen) -> dict:
    """Phase G: K8-K11 against their plain versions at bs16 L1370, K8
    against K6 and the int8 GEMM alone, the kernels' pre-pass/main split,
    and the bs16 518px forward with int8 kernels, int8 plain and bf16
    kernels."""
    from ucod_dpl_tpu_torch.models.convert import params_to
    from ucod_dpl_tpu_torch.models.dba import fg_logits_live
    from ucod_dpl_tpu_torch.ops import fused_layers as FL
    from ucod_dpl_tpu_torch.ops.quant import dense_w8a8_pre, int8_matmul, quantize_act
    from ucod_dpl_tpu_torch.tools.attention_ab import _device_ms

    dev = fe8.device
    norm, q8, f32 = _int8_layer(gen, dev, with_f32=True)
    x = torch.randn(16, 1370, SERVE_DIM, generator=gen, device=dev).to(torch.bfloat16)
    eps = 1e-6
    _log("int8 timing (CUDA events, interleaved plain/kernel/kernel/plain, bs16 L1370):")
    pairs = {
        "K8": (lambda: FL.layernorm_qkv_w8a8_reference(x, norm, q8["q"], q8["k"], q8["v"], eps),
               lambda: FL.layernorm_qkv_w8a8(x, norm, q8["q"], q8["k"], q8["v"], eps)),
        "K9": (lambda: FL.layernorm_fc1_gelu_w8a8_reference(x, norm, q8["fc1"], eps),
               lambda: FL.layernorm_fc1_gelu_w8a8(x, norm, q8["fc1"], eps)),
        "K10": (lambda: FL.dense_quant_w8a8_reference(x, q8["out"], torch.bfloat16),
                lambda: FL.dense_quant_w8a8(x, q8["out"], torch.bfloat16)),
        "K11": (lambda: FL.layernorm_mlp_w8a8_reference(x, norm, q8["fc1"], q8["fc2"], eps),
                lambda: FL.layernorm_mlp_w8a8(x, norm, q8["fc1"], q8["fc2"], eps)),
    }
    # two times of each: by events around back-to-back calls (how every
    # kernel is timed, the host's time per call when that is the longer),
    # and the card's own time (_device_ms: the calls queued behind a sleep
    # kernel), since a K8 or K10 call takes about as long on the host
    out = {}
    for name, (plain, kernel) in pairs.items():
        out[name] = _ab_ms(plain, kernel, 20)
        out[f"{name}_device"] = (_device_ms(kernel), _device_ms(plain))
        _log(f"  {name}: kernel {out[name][0]:.4f} ms, plain {out[name][1]:.4f} ms; device: kernel "
             f"{out[f'{name}_device'][0]:.4f} ms, plain {out[f'{name}_device'][1]:.4f} ms")
    # K11 against the MLP half of the split path on the same x: K9's kernel,
    # then fc2 as torch._int_mm with its f32 rescale (what int8_mlp="split" runs)
    def split_half():
        return dense_w8a8_pre(*FL.layernorm_fc1_gelu_w8a8(x, norm, q8["fc1"], eps), q8["fc2"], torch.bfloat16)

    out["K11_vs_split"] = _ab_ms(split_half, pairs["K11"][1], 20)
    out["K11_vs_split_device"] = (_device_ms(pairs["K11"][1]), _device_ms(split_half))
    _log(f"  K11 {out['K11_vs_split'][0]:.4f} ms against the split MLP half (K9 + dense_w8a8_pre) "
         f"{out['K11_vs_split'][1]:.4f} ms (device {out['K11_vs_split_device'][0]:.4f} against "
         f"{out['K11_vs_split_device'][1]:.4f})")
    # K8 against K6 on the same x, K6 on the same layer's weights in bf16
    lins = [{"w": f32[n]["w"].to(torch.bfloat16), "b": f32[n]["b"]} for n in "qkv"]

    def k6():
        return FL.layernorm_qkv(x, norm, *lins, eps)

    out["K8_vs_K6"] = _ab_ms(k6, pairs["K8"][1], 20)
    out["K8_vs_K6_device"] = (_device_ms(pairs["K8"][1]), _device_ms(k6))
    # the int8 GEMM alone (cuBLASLt through torch._int_mm, a yardstick: each
    # kernel computes more) at K8's (21920 x 768 . 768 x 2304) and K9's
    # (. 768 x 3072) shapes, on the codes of LN(x)
    codes = quantize_act(FL._layernorm_f32(x, norm, eps))[0]
    w_qkv = torch.cat([q8[n]["w_q"] for n in "qkv"])
    for key, w in (("int_mm_qkv", w_qkv), ("int_mm_fc1", q8["fc1"]["w_q"])):
        out[key] = _time_ms(lambda: int8_matmul(codes, w), 20)
        out[f"{key}_device"] = _device_ms(lambda: int8_matmul(codes, w))
    _log(f"  K8 {out['K8_vs_K6'][0]:.4f} ms against K6 (bf16 weights, same x) {out['K8_vs_K6'][1]:.4f} ms (device "
         f"{out['K8_vs_K6_device'][0]:.4f} against {out['K8_vs_K6_device'][1]:.4f}); torch._int_mm alone: K8's "
         f"shape {out['int_mm_qkv']:.4f} ms (device {out['int_mm_qkv_device']:.4f}), K9's shape "
         f"{out['int_mm_fc1']:.4f} ms (device {out['int_mm_fc1_device']:.4f})")
    for name in ("K8", "K9", "K10", "K11"):
        _trace(pairs[name][1], f"{name} bs16 L1370 (pre-pass and main kernel)", n=5, top=4)
    _trace(split_half, "the split MLP half bs16 L1370 (K9, torch._int_mm, rescale)", n=5, top=8)

    dec = params_to(decoder, dev)
    px = torch.randn(16, 518, 518, 3, generator=gen, device=dev)
    with torch.inference_mode():
        def fwd(plain, quant, int8_mlp="split"):
            return lambda: fg_logits_live(fe8.params, dec, px, fe8.config, compute_dtype=torch.bfloat16, size=68,
                                          plain=plain, quant=quant, int8_mlp=int8_mlp)

        runs = {"int8 plain": fwd(True, fe8._qparams), "int8 kernels": fwd(False, fe8._qparams),
                "bf16 kernels": fwd(False, None), "int8 kernels, whole MLP": fwd(False, fe8._qparams, "whole")}
        order = list(runs) + list(runs)[::-1]
        samples = {k: [] for k in runs}
        for k in order:
            samples[k].append(_time_ms(runs[k], 5))
        _trace(runs["int8 kernels"], "fg_logits_live bs16 518px int8 kernels")
        _trace(runs["int8 kernels, whole MLP"], "fg_logits_live bs16 518px int8 kernels, whole MLP (K11)")
    for k, v in samples.items():
        ms = sum(v) / len(v)
        out[f"fwd {k}"] = ms
        _log(f"  fg_logits_live bs16 518px, {k}: {ms:.3f} ms = {16e3 / ms:.2f} img/s (runs {v[0]:.3f}, {v[1]:.3f})")
    return out


def phase_k5(gen, dev) -> float:
    """Phase H: K5 (the forward kernel on the per-head layout) against its
    plain version, odd head counts at the other head dims on the packed
    layout, then the dispatch of an odd head count."""
    from ucod_dpl_tpu_torch.ops.attention import (
        heads_attention,
        heads_attention_reference,
        multi_head_attention,
        packed_attention,
        packed_attention_reference,
    )

    _log("K5 per-head attention (the forward kernel, one head per batch element) vs plain (bf16):")
    worst = 0.0
    for name, bh, l, d, q_scale in K5_CASES:
        q, k, v = (_nan_tailed_shape(gen, dev, (bh, l, d), s) for s in (q_scale, 1.0, 1.0))
        out = heads_attention(q, k, v, d ** -0.5, out=_nan_like(q))
        torch.cuda.synchronize()
        ref = heads_attention_reference(q, k, v, d ** -0.5)
        worst = max(worst, _check(name, out, ref, K1_TOL * ref.float().abs().max().item()))
    _log("odd head counts on the packed layout vs plain (bf16, q x3):")
    for name, b, l, nh, d in ODD_HEADS_CASES:
        q, k, v = (_nan_tailed_shape(gen, dev, (b, l, nh * d), s) for s in (3.0, 1.0, 1.0))
        out = packed_attention(q, k, v, nh, d ** -0.5, out=_nan_like(q))
        torch.cuda.synchronize()
        ref = packed_attention_reference(q, k, v, nh, d ** -0.5)
        worst = max(worst, _check(name, out, ref, K1_TOL * ref.float().abs().max().item()))
    q = torch.randn(2, 257, 3 * 64, generator=gen, device=dev).to(torch.bfloat16)
    before = (packed_attention.launches, heads_attention.launches)
    multi_head_attention(q, q, q, 3, 0.125)
    delta = (packed_attention.launches - before[0], heads_attention.launches - before[1])
    _log(f"  multi_head_attention with 3 heads of 64: packed_attention/heads_attention launches {delta}")
    if delta != (1, 0):
        raise AssertionError(f"3 heads launched packed_attention/heads_attention {delta}, expected (1, 0)")
    return worst


def _features_plain(fe, images: np.ndarray, params, dtype) -> torch.Tensor:
    from ucod_dpl_tpu_torch.models.dino import dino_forward

    with torch.inference_mode():
        px = torch.from_numpy(images).to(fe.device)
        return dino_forward(params, px, fe.config, compute_dtype=dtype, plain=True)["key_features"].float()


def phase_tp(seed: int, dev, fe_cfg) -> dict:
    """Phase I: tensor-parallel feature extraction of a bs16 batch at the
    backbone's own image size (dinov2-base: full width and depth, 518px),
    one card named four times by the mesh."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.models.dino import dino_forward
    from ucod_dpl_tpu_torch.parallel import build_mesh

    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    out = {}
    fes = {}
    for mesh_name, mesh_cfg in (("model=4", {"data": 1, "model": 4}), ("data=2 x model=2", {"data": 2, "model": 2})):
        fe = FeatureExtractor(fe_cfg, mesh=build_mesh(mesh_cfg, devices=[dev] * 4), seed=seed, strict=False)
        c = fe.config
        depth, grid = c.num_layers, c.image_size // c.patch_size
        images = np.random.default_rng(seed + 9).standard_normal((16, c.image_size, c.image_size, 3)).astype(np.float32)
        _log(f"TP extraction: {c.variant} {c.hidden_size}-wide x{depth} layers, {c.num_heads} heads, "
             f"{c.image_size}px, bs16, {fe.compute_dtype}, mesh {mesh_cfg} on one card")
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        feats = fe.extract(images)
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        _log(f"  extract: {secs:.3f} s host clock (first call), features {feats.shape}, launches {launches}")
        # every head count goes to the packed forward: K1's wrapper, 4 shards a layer
        want = {**{k: 0 for k in counts}, "K1": 4 * (depth - 1)}
        if launches != want:
            raise AssertionError(f"TP extract on {mesh_cfg}: launches {launches}, expected {want}")
        if feats.shape != (16, grid, grid, c.hidden_size) or not np.isfinite(feats).all():
            raise AssertionError(f"TP extract on {mesh_cfg}: features {feats.shape}, finite {np.isfinite(feats).all()}")
        out[f"launches {mesh_name}"] = launches
        fes[mesh_name] = (fe, feats)

    fe4 = fes["model=4"][0]
    f32 = FeatureExtractor(fe_cfg, device=dev, compute_dtype=torch.float32, seed=seed, strict=False)
    ref = _features_plain(f32, images, f32.params, torch.float32)
    err_plain = (_features_plain(fe4, images, fe4.params, torch.bfloat16) - ref).abs().max().item()
    bound = 1.5 * err_plain + 1e-3
    for mesh_name, (fe, feats) in fes.items():
        err = (torch.from_numpy(feats).to(dev) - ref).abs().max().item()
        _log(f"  TP features ({mesh_name}) vs f32 unsharded plain: max_abs_err {err:.6g}, bf16 unsharded plain "
             f"{err_plain:.6g}, bound {bound:.6g} (max |f32| {ref.abs().max().item():.4g})")
        if not (np.isfinite(err) and err <= bound):
            raise AssertionError(f"TP ({mesh_name}) features error {err} exceeds {bound}")
        out[f"err {mesh_name}"] = err
    out["err_plain"] = err_plain
    del f32, ref

    # timing: the TP extract (model=4, 3 heads a shard) against the unsharded one (K1 + K6)
    unsharded = FeatureExtractor(fe_cfg, device=dev, seed=seed, strict=False)
    px = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        runs = {
            "unsharded extract": lambda: unsharded.extract(images),
            "TP model=4 extract": lambda: fe4.extract(images),
            "unsharded forward": lambda: dino_forward(unsharded.params, px, fe4.config,
                                                      compute_dtype=fe4.compute_dtype),
            "TP model=4 forward": lambda: dino_forward(fe4._mesh_params[0], px, fe4.config,
                                                       compute_dtype=fe4.compute_dtype, tp_shard=fe4.tp_shard),
        }
        samples = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            samples[k].append(_time_ms(runs[k], 3, warmup=1))
    _log(f"  timing (CUDA events, interleaved, bs16 {fe4.config.image_size}px {fe4.compute_dtype}; extract "
         "includes the host copies):")
    for k, v in samples.items():
        out[k] = sum(v) / len(v)
        _log(f"    {k}: {out[k]:.3f} ms (runs {v[0]:.3f}, {v[1]:.3f})")
    _trace(runs["TP model=4 forward"], "TP model=4 forward")
    return out


def _trace(fn, what: str, n: int = 3, top: int = 14, inference: bool = True) -> None:
    """torch.profiler over ``n`` calls of ``fn`` after two warm-ups: kernel
    time and launches per call, the device's busy share of the host wall,
    and the kernels that take the most device time.  ``inference``: under
    ``torch.inference_mode`` (not for a training step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode() if inference else contextlib.nullcontext():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    _log(f"  trace of {what} ({n} calls): {total:.3f} ms of kernel time and {launches:.0f} launches per call, "
         f"host wall {wall:.3f} ms under the profiler, device busy {total / wall:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / n
        _log(f"    {ms:8.3f} ms {ms / total:6.3f} x{e.count / n:5.0f}  {e.key[:110]}")


def phase_k7(gen, dev, fe) -> dict:
    """Phase J: K7 against its plain version, its path (the MLP halves of the
    backbone's 11 layers through K7), and its timing."""
    from ucod_dpl_tpu_torch.ops.fused_layers import (
        dense,
        layer_norm,
        layernorm_fc1_gelu,
        layernorm_fc1_gelu_reference,
    )
    from ucod_dpl_tpu_torch.tools.attention_ab import _device_ms

    d, f, eps = SERVE_DIM, MLP_DIM, 1e-6
    norm = {"scale": 1 + 0.1 * torch.randn(d, generator=gen, device=dev),
            "bias": 0.1 * torch.randn(d, generator=gen, device=dev)}
    fc1 = {"w": (torch.randn(f, d, generator=gen, device=dev) / d ** 0.5).to(torch.bfloat16),
           "b": 0.1 * torch.randn(f, generator=gen, device=dev)}
    _log("K7 LayerNorm + fc1 + GELU vs plain (bf16, 768 -> 3072):")
    worst = 0.0
    for name, rows in K7_ROWS:
        x = _nan_tailed(gen, dev, 1, rows)
        out = layernorm_fc1_gelu(x, norm, fc1, eps, out=torch.full((1, rows, f), float("nan"), dtype=torch.bfloat16,
                                                                     device=dev))
        torch.cuda.synchronize()
        ref = layernorm_fc1_gelu_reference(x, norm, fc1, eps)
        worst = max(worst, _check(name, out, ref, K7_TOL * ref.float().abs().max().item()))

    # its path: the MLP half of each of the serving backbone's 11 layers,
    # with K7 in place of LN + dense + GELU, on a bs16 hidden state of its
    # token count (1370 at 518px)
    layers = fe.params["layers"][:-1]
    c = fe.config
    tokens = (c.image_size // c.patch_size) ** 2 + 1
    x = torch.randn(16, tokens, c.hidden_size, generator=gen, device=dev).to(torch.bfloat16)

    def mlp_half(x, layer, fused):
        if fused:
            h = layernorm_fc1_gelu(x, layer["norm2"], layer["fc1"], eps)
        else:
            h = torch.nn.functional.gelu(dense(layer_norm(x, layer["norm2"], eps), layer["fc1"], torch.bfloat16),
                                         approximate="tanh")
        return x + dense(h, layer["fc2"], torch.bfloat16) * layer["ls2"]

    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    for fn in counts.values():
        fn.launches = 0
    with torch.inference_mode():
        y = x
        for layer in layers:
            y = mlp_half(y, layer, True)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    _log(f"  MLP halves of {len(layers)} layers through K7: launches {launches}, output finite "
         f"{bool(torch.isfinite(y).all())}")
    if launches != {**{k: 0 for k in counts}, "K7": len(layers)} or not torch.isfinite(y).all():
        raise AssertionError(f"K7 path: launches {launches}, expected K7 {len(layers)} and nothing else")

    _log(f"K7 timing (CUDA events, interleaved, bs16 L{tokens}):")
    xs = torch.randn(16, 1370, d, generator=gen, device=dev).to(torch.bfloat16)
    k7_ms, k7_plain = _ab_ms(lambda: layernorm_fc1_gelu_reference(xs, norm, fc1, eps),
                             lambda: layernorm_fc1_gelu(xs, norm, fc1, eps), 20)
    with torch.inference_mode():
        layer = layers[0]
        half_fused, half_composed = _ab_ms(lambda: mlp_half(x, layer, False), lambda: mlp_half(x, layer, True), 20)
        up_fused, up_composed = _ab_ms(
            lambda: torch.nn.functional.gelu(dense(layer_norm(x, layer["norm2"], eps), layer["fc1"], torch.bfloat16),
                                             approximate="tanh"),
            lambda: layernorm_fc1_gelu(x, layer["norm2"], layer["fc1"], eps), 20)
        dev_ms = {
            "K7": _device_ms(lambda: layernorm_fc1_gelu(xs, norm, fc1, eps)),
            "plain": _device_ms(lambda: layernorm_fc1_gelu_reference(xs, norm, fc1, eps)),
            "composed_up": _device_ms(lambda: torch.nn.functional.gelu(
                dense(layer_norm(x, layer["norm2"], eps), layer["fc1"], torch.bfloat16), approximate="tanh")),
            "fused_up": _device_ms(lambda: layernorm_fc1_gelu(x, layer["norm2"], layer["fc1"], eps)),
            "half_composed": _device_ms(lambda: mlp_half(x, layer, False)),
            "half_fused": _device_ms(lambda: mlp_half(x, layer, True)),
        }
    _log(f"  K7: kernel {k7_ms:.4f} ms, plain {k7_plain:.4f} ms; LN + fc1 + GELU as the layer composes it "
         f"(LN, cuBLAS dense, GELU) {up_composed:.4f} ms vs K7 {up_fused:.4f} ms; one layer's MLP half "
         f"composed {half_composed:.4f} ms vs with K7 {half_fused:.4f} ms")
    _log(f"  device: K7 {dev_ms['K7']:.4f} ms, plain {dev_ms['plain']:.4f} ms; LN + fc1 + GELU composed "
         f"{dev_ms['composed_up']:.4f} ms vs K7 {dev_ms['fused_up']:.4f} ms; MLP half composed "
         f"{dev_ms['half_composed']:.4f} ms vs with K7 {dev_ms['half_fused']:.4f} ms")
    return {"err": worst, "launches": launches["K7"], "ms": k7_ms, "plain_ms": k7_plain,
            "composed_up_ms": up_composed, "fused_up_ms": up_fused, "mlp_half_composed_ms": half_composed,
            "mlp_half_fused_ms": half_fused, "device_ms": dev_ms}


def phase_k5_timing(gen, dev) -> dict:
    """The forward at K5's two shapes against its plain version and one
    scaled_dot_product_attention call on views of the same tensors: the
    per-head (48, 1370, 64) and the tensor-parallel shard's packed (16, 1370,
    3 * 64), which the TP path runs (the same work: 48 heads of L 1370)."""
    from ucod_dpl_tpu_torch.ops.attention import (
        heads_attention,
        heads_attention_reference,
        packed_attention,
        packed_attention_reference,
    )

    out = {}
    q, k, v = (torch.randn(48, 1370, 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    ms, plain_ms = _ab_ms(lambda: heads_attention_reference(q, k, v, 0.125), lambda: heads_attention(q, k, v, 0.125), 20)
    sdpa = _sdpa_ms(*(x.unsqueeze(1) for x in (q, k, v)), 0.125, 20)
    _log(f"K5 timing (CUDA events, interleaved) BH48 L1370 d64 per-head: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
         f"scaled_dot_product_attention {sdpa:.4f} ms")
    out["per-head"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": sdpa}
    q, k, v = (torch.randn(16, 1370, 3 * 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    ms, plain_ms = _ab_ms(lambda: packed_attention_reference(q, k, v, 3, 0.125),
                          lambda: packed_attention(q, k, v, 3, 0.125), 20)
    sdpa = _sdpa_ms(*(x.view(16, 1370, 3, 64).transpose(1, 2) for x in (q, k, v)), 0.125, 20)
    _log(f"K5 timing (CUDA events, interleaved) TP shard (16, 1370, 3x64) packed: kernel {ms:.4f} ms, "
         f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {sdpa:.4f} ms")
    out["tp-shard"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": sdpa}
    return out


# Phase K: the synthetic RefCOD layout of the eval entry (COD-like image
# sizes, one ground-truth blob each), written in JPEG/PNG through Pillow.
EVAL_IMAGES = 32
EVAL_SIZES = ((480, 640), (600, 800), (720, 1280))
EVAL_CACHE_BATCH = 8  # CODDataset's default cache_build_batch
EVAL_KEYS = ("ACC", "mIOU", "E_MAX", "E_MEAN", "F_MAX", "F_MEAN", "SMeasure", "MAE", "WFM")


def _host_stack() -> str:
    """The host packages the eval path reads files with, and whether the
    native image pipe (``native/imagepipe.cpp``, its resize) builds here."""
    import importlib

    parts = []
    for mod in ("PIL", "safetensors", "yaml", "scipy"):
        try:
            parts.append(f"{mod} {importlib.import_module(mod).__version__}")
        except ImportError:
            parts.append(f"{mod} missing")
    from ucod_dpl_tpu_torch.utils import native

    built = native.get_imagepipe_lib() is not None
    parts.append("native image pipe " + ("built" if built else "not built (Pillow resizes)"))
    return ", ".join(parts)


def _write_eval_dataset(root: str, seed: int) -> list:
    """``root/SYN/{im,gt}``: phase K's 32 images."""
    return _write_cod_images(root, "SYN", EVAL_IMAGES, seed + 20)


def _write_cod_images(root: str, name: str, n: int, seed: int, labels: bool = True) -> list:
    """``root/name/im`` (and ``gt`` with ``labels``): ``n`` smooth seeded
    colour fields at the COD sizes, each with one tinted elliptic blob, and
    the blob as the ground truth."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    im_dir, gt_dir = os.path.join(root, name, "im"), os.path.join(root, name, "gt")
    os.makedirs(im_dir)
    if labels:
        os.makedirs(gt_dir)
    sizes = []
    for i in range(n):
        h, w = EVAL_SIZES[i % len(EVAL_SIZES)]
        coarse = (rng.random((h // 40, w // 40, 3)) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC)).astype(np.float32)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.08, 0.25) * h, rng.uniform(0.08, 0.25) * w
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img[blob] = img[blob] * 0.8 + rng.uniform(0, 255, 3) * 0.2
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(im_dir, f"{i:03d}.jpg"), quality=90)
        if labels:
            Image.fromarray(blob.astype(np.uint8) * 255).save(os.path.join(gt_dir, f"{i:03d}.png"))
        sizes.append((h, w))
    return sizes


def phase_eval(seed: int, dev, smi: str) -> dict:
    """Phase K: ``cli.eval_main`` on configs/uscod/UCOD-DPL_dinov2.py over a
    32-image synthetic dataset on the card, twice (the first run builds the
    feature cache, the second reads it), with its launch counts, outputs,
    cached-feature accuracy, host-clock rates and a profiler split."""
    import shutil

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
    from ucod_dpl_tpu_torch.utils.fileio import ArrayCache

    _log(f"eval entry: host stack: {_host_stack()}")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work", "chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    sizes = _write_eval_dataset(os.path.join(root, "RefCOD"), seed)
    _log(f"  dataset: {EVAL_IMAGES} images at {sorted(set(sizes))}, written in {time.perf_counter() - t0:.2f} s")
    paths = sorted(glob.glob(os.path.join(root, "RefCOD", "SYN", "im", "*.jpg")))

    # the seeded decoder, its fg bias moved to the 60th percentile of its
    # logits on the first cache batch (the eval's own seeded backbone), so
    # that its masks mix foreground and background and the crop path runs
    fe_cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = FeatureExtractor(fe_cfg, device=dev, seed=0, strict=False)
    decoder = init_rev_decoder(seed + 1, SERVE_DIM)
    batch = load_image_batch_transform(paths[:EVAL_CACHE_BATCH], (518, 518))
    with torch.inference_mode():
        fg, _, _ = rev_decoder_forward_resized(decoder, torch.from_numpy(fe.extract(batch)), 68)
    decoder = decoder._replace(conv_out_fg_b=decoder.conv_out_fg_b - torch.quantile(fg.flatten(), 0.6))
    ckpt = os.path.join(root, "decoder.safetensors")
    save_decoder_checkpoint(ckpt, decoder, init_rev_decoder(seed + 2, SERVE_DIM))

    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    argv = ["-c", "configs/uscod/UCOD-DPL_dinov2.py", "--load_from", ckpt, "--datasets", "SYN",
            "--work_dir", os.path.join(root, "work_dir"), "--opts",
            "dataset_cfg.dataset_dir", os.path.join(root, "RefCOD"),
            "dataset_cfg.cache_dir", os.path.join(root, "cache"),
            "log_cfg.log_path", os.path.join(root, "logs"), "val_cfg.look_twice_th", "0.95"]
    depth = fe.config.num_layers
    out = {}
    for run in ("first", "second"):
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        runner = cli.eval_main(argv)["SYN"]
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        ev, ds = runner.evaluator, runner.val_dataset
        cache = ds.caches.get("features")
        # the first run builds the cache (batches of 8) and the second reads it
        forwards = ev.crop_batches + (-(-EVAL_IMAGES // EVAL_CACHE_BATCH) if run == "first" else 0)
        want = {**{k: 0 for k in counts}, "K1": (depth - 1) * forwards, "K6": (depth - 1) * forwards}
        _log(f"  {run} run: {secs:.3f} s host clock in all, cache build "
             + (f"{ds.build_seconds:.3f} s ({EVAL_IMAGES / ds.build_seconds:.2f} img/s)" if ds.build_seconds
                else "none (read)")
             + f", eval sweep {ev.seconds:.3f} s ({EVAL_IMAGES / ev.seconds:.2f} img/s), {ev.crops} LookTwice "
             f"crops in {ev.crop_batches} backbone calls, launches {launches} [{smi}]")
        _log("    eval sweep by stage, host clock: " + ", ".join(f"{k} {v:.3f} s" for k, v in ev.split.items()))
        if launches != want:
            raise AssertionError(f"eval {run} run: launches {launches}, expected {want}")
        if (ds.build_seconds is None) != (run == "second"):
            raise AssertionError(f"eval {run} run: cache build {ds.build_seconds}")
        if cache.mode != "r" or len(cache) != EVAL_IMAGES:
            raise AssertionError(f"eval {run} run: feature cache mode {cache.mode}, {len(cache)} entries")
        if ev.crops == 0:
            raise AssertionError(f"eval {run} run: no LookTwice crop (look_twice_th 0.95 should force them)")
        result = ev.result
        if set(result) != set(EVAL_KEYS) or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in result.values()):
            raise AssertionError(f"eval {run} run: result {result}")
        _log(f"    result {result}")
        out[run] = dict(secs=secs, launches=launches, build_s=ds.build_seconds, eval_s=ev.seconds,
                        crops=ev.crops, crop_batches=ev.crop_batches, result=result, split=dict(ev.split))
    if out["second"]["result"] != out["first"]["result"]:
        raise AssertionError(f"eval from the cache: {out['second']['result']} != {out['first']['result']}")

    # what the first run wrote: 32 finite cache entries of the JAX package's
    # shape, 32 masks at their ground-truth sizes
    grid = 518 // fe.config.patch_size
    feats = [cache.read(i) for i in range(EVAL_IMAGES)]
    if any(f.shape != (grid, grid, SERVE_DIM) or f.dtype != np.float32 or not np.isfinite(f).all() for f in feats):
        raise AssertionError("feature cache: an entry of the wrong shape or dtype, or not finite")
    from PIL import Image

    preds = os.path.join(root, "logs", "preds", "SYN")
    masks = sorted(os.listdir(preds))
    got_sizes = [Image.open(os.path.join(preds, m)).size[::-1] for m in masks]
    if masks != [f"{i:03d}.png" for i in range(EVAL_IMAGES)] or got_sizes != sizes:
        raise AssertionError(f"masks: {masks[:3]}... at {got_sizes[:3]}...")
    _log(f"  cache: {EVAL_IMAGES} finite float32 entries of {feats[0].shape}; {len(masks)} masks at their "
         "ground-truth sizes")

    # accuracy: the cached features (the kernels, bf16) of 4 images against
    # the f32 plain path, beside the bf16 plain path
    images = load_image_batch_transform(paths[:4], (518, 518))
    f32 = FeatureExtractor(fe_cfg, device=dev, compute_dtype=torch.float32, seed=0, strict=False)
    ref = _features_plain(f32, images, f32.params, torch.float32)
    del f32
    err_plain = (_features_plain(fe, images, fe.params, torch.bfloat16) - ref).abs().max().item()
    err = (torch.from_numpy(np.stack(feats[:4])).to(dev) - ref).abs().max().item()
    bound = 1.5 * err_plain + 1e-3
    _log(f"  cached features bs4 vs f32 plain: max_abs_err {err:.6g}, bf16 plain {err_plain:.6g}, bound "
         f"{bound:.6g} (max |f32| {ref.abs().max().item():.4g})")
    if not (np.isfinite(err) and err <= bound):
        raise AssertionError(f"cached features error {err} exceeds {bound}")
    out["err"], out["err_plain"] = err, err_plain

    # where a cache-build batch's time goes: the host decode (by host clock)
    # and the extract on the card (profiler)
    t0 = time.perf_counter()
    batch = load_image_batch_transform(paths[:EVAL_CACHE_BATCH], (518, 518))
    decode_s = time.perf_counter() - t0
    _log(f"  cache-build batch of {EVAL_CACHE_BATCH}: host decode + resize + normalise {decode_s * 1e3:.1f} ms "
         f"host clock [{smi}]")
    out["decode_ms"] = decode_s * 1e3
    _trace(lambda: fe.extract(batch), f"one cache-build batch (FeatureExtractor.extract, {EVAL_CACHE_BATCH} x "
           f"518px, host copies included) [{smi}]")
    # and the eval sweep from the cache: the device's share of its wall
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.eval_main(argv)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    _log(f"  trace of the eval entry from the cache: {busy:.3f} ms of kernel time in {wall:.3f} ms of host wall "
         f"under the profiler, device busy {busy / wall:.4f} [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        _log(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  {e.key[:100]}")
    out["busy"] = busy / wall
    return out


# Phase M, then L: the train entry on configs/uscod/UCOD-DPL_dinov2.py as
# shipped (its train set TR-CAMO+TR-COD10K, val set TE-CAMO, batch 16), on
# synthetic images at the COD sizes of phase K and the pseudo-label cache
# that phase M generates for them.
TRAIN_SETS = (("TR-CAMO", 24), ("TR-COD10K", 24))
TRAIN_IMAGES = sum(n for _, n in TRAIN_SETS)
TRAIN_VAL_IMAGES = 8
TRAIN_BATCH = 16
PL_SIZE = 224  # the generator's defaults: 224px in batches of 16, th_bkg 0.6
PL_BATCH = 16
PL_GRID = PL_SIZE // 14


def _pl_masks(attn: torch.Tensor, toks: torch.Tensor) -> np.ndarray:
    """The generator's masks of a batch's CLS attention and key tokens: 1 -
    the background mask at th_bkg 0.6, small components cleaned."""
    from ucod_dpl_tpu_torch.ops.pseudo_label import compute_background_mask, refine_small_components

    bkg, _ = compute_background_mask(attn.float(), toks.float(), (PL_GRID, PL_GRID), th_bkg=0.6)
    return np.stack([refine_small_components(m) for m in 1.0 - bkg.cpu().numpy()])


def phase_pseudo_labels(seed: int, dev, smi: str) -> dict:
    """Phase M: ``cli.generate_pseudo_label_main`` at full width on the card
    (seeded random dinov2-base, 224px, bf16, batch 16) over phase L's 48
    synthetic train images in two directories, with its launches, the cache
    and its meta, the kernel path's CLS attention, key tokens and masks on
    4 images against the f32 plain path, img/s by host clock and the
    device's busy share.  Returns phase L's world (its directories)."""
    import hashlib
    import shutil
    from pathlib import Path

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.data import feature_extractor as fe_mod
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.dino import dino_forward
    from ucod_dpl_tpu_torch.utils.fileio import ArrayCache

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "RefCOD")
    t0 = time.perf_counter()
    for i, (name, n) in enumerate(TRAIN_SETS):
        _write_cod_images(data, name, n, seed + 30 + i, labels=False)
    _write_cod_images(data, "TE-CAMO", TRAIN_VAL_IMAGES, seed + 40)
    train_set = "+".join(name for name, _ in TRAIN_SETS)
    _log(f"pseudo-labels: {TRAIN_IMAGES} train images ({train_set}) and {TRAIN_VAL_IMAGES} val images (TE-CAMO) at "
         f"{EVAL_SIZES}, written in {time.perf_counter() - t0:.2f} s")

    # no backbone weights are in the repository: the generator's extractor
    # takes its seeded random init (seed 0, as the train entry's Runner)
    argv = ["--dataset", train_set, "--image_path", os.path.join(data, "{}", "im"),
            "--cache_path", os.path.join(root, "cache", "pseudo_label_cache"),
            "--backbone_weights", os.path.join(root, "no_weights"), "--image_size", str(PL_SIZE),
            "--batch_size", str(PL_BATCH), "--device", str(dev)]
    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    times = []
    orig = fe_mod.FeatureExtractor.extract_with_attention

    def timed(self, images):  # the generation loop's start: the first batch's forward
        if not times:
            torch.cuda.synchronize()
            times.append(time.perf_counter())
        return orig(self, images)

    for fn in counts.values():
        fn.launches = 0
    fe_mod.FeatureExtractor.extract_with_attention = timed
    try:
        t0 = time.perf_counter()
        cache_dir = cli.generate_pseudo_label_main(argv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        fe_mod.FeatureExtractor.extract_with_attention = orig
    launches = {k: fn.launches for k, fn in counts.items()}
    batches = -(-TRAIN_IMAGES // PL_BATCH)
    want = {**{k: 0 for k in counts}, "K1": 11 * batches, "K6": 11 * batches}
    img_per_s = TRAIN_IMAGES / (t1 - times[0])
    _log(f"  generate_pseudo_label: {t1 - t0:.3f} s host clock in all, {t1 - times[0]:.3f} s from the first batch "
         f"({img_per_s:.2f} img/s, {batches} batches of {PL_BATCH} at {PL_SIZE}px), launches {launches} [{smi}]")
    _check_launches("generate_pseudo_label", launches, want)

    # the cache: 48 binary (16, 16, 1) float32 entries and the JAX
    # generator's meta
    cache = ArrayCache(cache_dir)
    paths = sorted(p for ds in train_set.split("+") for p in Path(data, ds, "im").glob("*.jpg"))
    meta = {"n": TRAIN_IMAGES, "fingerprint": hashlib.sha1("\n".join(p.stem for p in paths).encode()).hexdigest(),
            "th_bkg": 0.6}
    entries = [cache.read(i) for i in range(len(cache))] if cache.mode == "r" else []
    if len(entries) != TRAIN_IMAGES or cache.read_meta() != meta:
        raise AssertionError(f"pseudo-label cache: mode {cache.mode}, {len(entries)} entries, meta {cache.read_meta()}")
    if any(e.shape != (PL_GRID, PL_GRID, 1) or e.dtype != np.float32 or not np.isin(e, (0.0, 1.0)).all()
           for e in entries):
        raise AssertionError("pseudo-label cache: an entry of the wrong shape or dtype, or not binary")
    fg_share = float(np.mean(entries))
    _log(f"  cache: {len(entries)} binary {entries[0].shape} float32 entries, foreground share {fg_share:.4f}, "
         f"meta {meta}")

    # accuracy on 4 images: the kernel path (bf16, K1 + K6) and the bf16
    # plain path against the f32 plain path
    images = load_image_batch_transform(paths[:4], (PL_SIZE, PL_SIZE))
    fe_cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = fe_mod.FeatureExtractor(fe_cfg, device=dev, seed=0, strict=False)
    f32 = fe_mod.FeatureExtractor(fe_cfg, device=dev, compute_dtype=torch.float32, seed=0, strict=False)
    px = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        def plain(ex, dtype):
            out = dino_forward(ex.params, px, ex.config, compute_dtype=dtype, plain=True, want_cls_attention=True)
            return out["cls_attention"].float(), out["key_tokens"].float()

        ref, bf16_plain = plain(f32, torch.float32), plain(fe, torch.bfloat16)
        toks, _, attn = fe.extract_with_attention(images)
        kern = (torch.from_numpy(attn).to(dev), torch.from_numpy(toks).to(dev))
        masks = {name: _pl_masks(*v) for name, v in (("f32", ref), ("bf16 plain", bf16_plain), ("kernels", kern))}
    del f32
    out = {"launches": launches, "img_per_s": img_per_s, "fg_share": fg_share}
    for i, what in enumerate(("cls_attention", "key_tokens")):
        err = (kern[i] - ref[i]).abs().max().item()
        err_plain = (bf16_plain[i] - ref[i]).abs().max().item()
        bound = 1.5 * err_plain + 1e-3
        _log(f"  {what} bs4 vs f32 plain: max_abs_err {err:.6g}, bf16 plain {err_plain:.6g}, bound {bound:.6g} "
             f"(max |f32| {ref[i].abs().max().item():.4g})")
        if not (np.isfinite(err) and err <= bound):
            raise AssertionError(f"pseudo-labels: {what} error {err} exceeds {bound}")
        out[f"err_{what}"] = err
    differ = float((masks["kernels"] != masks["f32"]).mean())
    differ_plain = float((masks["bf16 plain"] != masks["f32"]).mean())
    bound = 1.5 * differ_plain + 0.002
    _log(f"  masks of 4 images vs the f32 plain path's: {differ:.6f} of the pixels differ, bf16 plain "
         f"{differ_plain:.6f}, bound {bound:.6f}; the cache's first 4 entries equal the kernel path's: "
         f"{all(np.array_equal(e[..., 0], m) for e, m in zip(entries[:4], masks['kernels']))}")
    if not differ <= bound:
        raise AssertionError(f"pseudo-labels: {differ} of the mask pixels differ from f32, bound {bound}")
    out["mask_differ"] = differ

    # the device's busy share of a regeneration (--overwrite), under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli.generate_pseudo_label_main(argv + ["--overwrite"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    _log(f"  trace of a regeneration (--overwrite, extractor init included): {busy:.3f} ms of kernel time in "
         f"{wall:.3f} ms of host wall under the profiler, device busy {busy / wall:.4f} [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        _log(f"    {e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  {e.key[:100]}")
    out.update(busy=busy / wall, root=root, data=data, train_set=train_set)
    return out


class _TrainProbe:
    """Instruments one ``cli.train_main`` call of phase L: keeps every step's
    loss (on the card until the run ends), times each epoch's train and
    discriminator phases (host clock, synchronised), each validation (with
    its LookTwice crop calls) and each save, times each LoRA step by CUDA
    events and by host clock, profiles the train phase of ``profile_epoch``,
    and, with ``preempt_after``, sends this process SIGTERM after that
    decoder (or LoRA) step.  The originals are restored on exit."""

    def __init__(self, preempt_after=None, profile_epoch=None):
        self.preempt_after, self.profile_epoch = preempt_after, profile_epoch
        self.losses = {"train": [], "dis": [], "lora": []}
        self.epochs, self.val, self.saves, self.lora_times = [], [], [], []
        self.prof, self.profiling = None, False
        self._patched = []

    def _patch(self, obj, name, make):
        orig = getattr(obj, name)
        self._patched.append((obj, name, orig))
        setattr(obj, name, make(orig))

    def _steps(self) -> int:
        return sum(len(v) for v in self.losses.values())

    def __enter__(self):
        from ucod_dpl_tpu_torch.engine import preempt, runner, train_loop

        probe = self

        def recording(kind, key):
            def make(orig_make):
                def make_step(*a, **k):
                    inner = orig_make(*a, **k)

                    def step(*sa):
                        if kind == "lora":
                            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            e0.record()
                        aux = inner(*sa)
                        if kind == "lora":
                            e1.record()
                            torch.cuda.synchronize()
                            probe.lora_times.append((e0, e1, time.perf_counter() - t0, probe.profiling))
                        probe.losses[kind].append(aux[key].detach())
                        if kind in ("train", "lora") and len(probe.losses[kind]) == probe.preempt_after:
                            os.kill(os.getpid(), signal.SIGTERM)
                            if preempt.requested() != signal.SIGTERM:
                                raise AssertionError("SIGTERM did not reach the train loop's handler")
                        return aux

                    return step

                return make_step

            return make

        self._patch(train_loop, "make_train_step", recording("train", "loss"))
        self._patch(train_loop, "make_discriminator_step", recording("dis", "dis_train_loss"))
        self._patch(train_loop, "make_lora_train_step", recording("lora", "loss"))

        def timed_phase(kind):
            def make(orig):
                def run(loop, epoch, *a):
                    from torch.profiler import ProfilerActivity, profile

                    prof = kind == "train" and epoch == probe.profile_epoch
                    ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if prof \
                        else contextlib.nullcontext()
                    n0 = probe._steps()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    probe.profiling = prof
                    with ctx as p:
                        orig(loop, epoch, *a)
                        torch.cuda.synchronize()
                    probe.profiling = False
                    probe.epochs.append((kind, epoch, probe._steps() - n0, time.perf_counter() - t0))
                    if prof:
                        probe.prof = (p, probe.epochs[-1][3] * 1e3)

                return run

            return make

        self._patch(train_loop.TrainLoop, "_run_epoch", timed_phase("train"))
        self._patch(train_loop.TrainLoop, "_train_discriminator", timed_phase("dis"))

        def timed(what):
            def make(orig):
                def call(obj, *a):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = orig(obj, *a)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    if what == "val":
                        probe.val.append((secs, obj.evaluator.crop_batches))
                    else:
                        probe.saves.append((what, secs))
                    return out

                return call

            return make

        self._patch(runner.Runner, "launch_val_look_twice", timed("val"))
        self._patch(runner.Runner, "save_checkpoint", timed("decoder safetensors"))
        self._patch(train_loop.TrainLoop, "_save_full_state", timed("full state npz"))
        self._patch(train_loop.TrainLoop, "_save_lora", timed("adapters + merged backbone"))
        return self

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self._patched):
            setattr(obj, name, orig)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
        return False

    def finite_losses(self, kind) -> np.ndarray:
        vals = torch.stack(self.losses[kind]).float().cpu().numpy() if self.losses[kind] else np.zeros(0)
        if not np.isfinite(vals).all():
            raise AssertionError(f"{kind} steps: non-finite losses {vals}")
        return vals

    def crop_batches(self) -> int:
        return sum(c for _, c in self.val)

    def log_trace(self, what: str, smi: str) -> float:
        """Print the profiled epoch's device time (kernels and copies; the
        optimizer's annotation spans on the device timeline, which enclose
        kernels counted already, left out), its busy share of the host wall
        under the profiler and the top device operations; return the device
        ms."""
        from torch.autograd import DeviceType

        prof, wall = self.prof
        spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
        ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.key not in spans]
        device_ms = sum(e.self_device_time_total for e in ops) / 1e3
        _log(f"    trace of {what}: {device_ms:.3f} ms of device time in {wall:.3f} ms of host wall under the "
             f"profiler, device busy {device_ms / wall:.4f} [{smi}]")
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
            _log(f"      {e.self_device_time_total / 1e3:8.3f} ms x{e.count:5d}  {e.key[:100]}")
        return device_ms


def _train_params(runner) -> list:
    """The decoder, EMA teacher, discriminator and its statistics, flat, on the host."""
    from ucod_dpl_tpu_torch.models.convert import tree_leaves

    return [t.detach().float().cpu() for tree in (runner.decoder_params, runner.decoder_ema_params,
                                                  runner.discriminator_params, runner.discriminator_stats)
            for t in tree_leaves(tree)]


def _check_launches(what: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def phase_train(seed: int, dev, smi: str, world: dict) -> dict:
    """Phase L: ``cli.train_main`` on configs/uscod/UCOD-DPL_dinov2.py at full
    width on the card over phase M's images and pseudo-labels (``world``):
    run A (cached features, 4 epochs), run B (the same, preempted by SIGTERM
    after its 7th decoder step and resumed), run C (LoRA, 2 epochs), run D
    (run C preempted after its 4th LoRA step and resumed); launches,
    outputs, files and rates."""
    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.convert import tree_leaves
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
    from ucod_dpl_tpu_torch.models.discriminator import init_discriminator
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint

    root, data, train_set = world["root"], world["data"], world["train_set"]
    _log(f"train entry: {TRAIN_IMAGES} train images ({train_set}), {TRAIN_VAL_IMAGES} val images (TE-CAMO), the "
         f"{PL_GRID}x{PL_GRID} pseudo-label cache generated in phase M")

    # the Runner's seeded towers (student from the config's seed 42, EMA
    # teacher from 43), each with its fg bias moved to the 60th percentile
    # of its logits on the val images (the run's own seeded backbone): the
    # teacher's masks are the student's targets through the APM merge, so
    # with both mixed the validations' masks mix foreground and background
    # and the crop path runs
    fe = FeatureExtractor(_Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None), device=dev,
                          seed=0, strict=False)
    val_paths = sorted(glob.glob(os.path.join(data, "TE-CAMO", "im", "*.jpg")))
    towers = []
    with torch.inference_mode():
        feats = torch.from_numpy(fe.extract(load_image_batch_transform(val_paths, (518, 518))))
        for tower_seed in (42, 43):
            tower = init_rev_decoder(tower_seed, SERVE_DIM)
            fg, _, _ = rev_decoder_forward_resized(tower, feats, 68)
            towers.append(tower._replace(conv_out_fg_b=tower.conv_out_fg_b - torch.quantile(fg.flatten(), 0.6)))
    del fe
    ckpt = os.path.join(root, "decoder.safetensors")
    save_decoder_checkpoint(ckpt, *towers)

    def argv(run, *flags, **opts):
        """The shipped config; paths, the schedule and ``opts`` overridden."""
        over = {"dataset_cfg.dataset_dir": data, "dataset_cfg.cache_dir": os.path.join(root, "cache"),
                "log_cfg.log_path": os.path.join(root, f"logs_{run}"), "train_cfg.max_epoch": "4",
                "train_cfg.start_finetune": "-1", "train_cfg.dis_intertrain": "2",
                "train_cfg.save_cfg.save_mode": "all", "train_cfg.save_cfg.save_interval": "2",
                "train_cfg.save_cfg.start_save": "0", "val_cfg.val_interval": "2", "val_cfg.start_val": "2",
                "val_cfg.look_twice_th": "0.95", **{k.replace("__", "."): v for k, v in opts.items()}}
        return ["-c", "configs/uscod/UCOD-DPL_dinov2.py", "--work_dir", os.path.join(root, "work_dir"),
                "--load_from", ckpt, *flags, "--opts", *(x for kv in over.items() for x in kv)]

    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    # every run with cuDNN's deterministic algorithms (the discriminator's
    # convolutions), so that a resume can be held to its uninterrupted run
    # bit for bit
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        # run A: cached features, 4 epochs of 3 steps, discriminator passes
        # at epochs 0 and 2, the finetune switch at epoch 3, saves and
        # validations at epochs 2 and 4
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with _TrainProbe(profile_epoch=1) as pa:
            run_a = cli.train_main(argv("a"))
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        depth = run_a.feature_extractor.config.num_layers
        forwards = -(-TRAIN_IMAGES // EVAL_CACHE_BATCH) + -(-TRAIN_VAL_IMAGES // EVAL_CACHE_BATCH) + pa.crop_batches()
        want = {**{k: 0 for k in counts}, "K1": (depth - 1) * forwards, "K6": (depth - 1) * forwards}
        losses, dis_losses = pa.finite_losses("train"), pa.finite_losses("dis")
        loop = run_a.train_loop
        _log(f"  run A (cached features, bs{TRAIN_BATCH}, 4 epochs): {secs:.3f} s host clock in all; train-set "
             f"cache build {run_a.train_dataset.build_seconds:.3f} s "
             f"({TRAIN_IMAGES / run_a.train_dataset.build_seconds:.2f} img/s), val-set "
             f"{run_a.val_dataset.build_seconds:.3f} s; launches {launches} [{smi}]")
        _log(f"    decoder losses {np.round(losses, 5).tolist()}, discriminator losses "
             f"{np.round(dis_losses, 5).tolist()}, best {loop.best_result}")
        for kind, epoch, steps, dt in pa.epochs:
            _log(f"    epoch {epoch} {kind}: {steps} steps in {dt:.4f} s, {steps / dt:.3f} steps/s host clock")
        _log("    validations (s, LookTwice crop calls): " + ", ".join(f"{s:.3f} ({c})" for s, c in pa.val)
             + "; saves: " + ", ".join(f"{w} {s:.4f} s" for w, s in pa.saves) + f" [{smi}]")
        _check_launches("run A", launches, want)
        if (len(losses), len(dis_losses)) != (12, 6):
            raise AssertionError(f"run A: {len(losses)} decoder and {len(dis_losses)} discriminator steps")
        init = [*towers, init_discriminator(44, 68, SERVE_DIM, False)[0]]
        final = [run_a.decoder_params, run_a.decoder_ema_params, run_a.discriminator_params]
        for name, a, b in zip(("decoder", "EMA", "discriminator"), init, final):
            if not any(not torch.equal(x, y.cpu()) for x, y in zip(tree_leaves(a), tree_leaves(b))):
                raise AssertionError(f"run A: the {name} did not move")
        files = set(os.listdir(run_a.ckp_dir))
        need = {f"{p}{e}{x}" for e in (2, 4) for p, x in (("epoch", ".safetensors"), ("state_epoch", ".npz"))}
        if not need <= files:
            raise AssertionError(f"run A: files {sorted(files)}, missing {sorted(need - files)}")
        if loop.best_result is None or not np.isfinite(loop.best_mae):
            raise AssertionError(f"run A: best result {loop.best_result}")
        if pa.crop_batches() == 0:
            raise AssertionError("run A: the validations made no LookTwice crop (the crop path did not run)")
        by = {(k, e): (s, dt) for k, e, s, dt in pa.epochs}
        out["cache_build_img_per_s"] = TRAIN_IMAGES / run_a.train_dataset.build_seconds
        out["decoder_steps_per_s"] = by[("train", 3)][0] / by[("train", 3)][1]
        out["dis_steps_per_s"] = by[("dis", 2)][0] / by[("dis", 2)][1]
        out["val_s"] = [s for s, _ in pa.val]
        out["save_s"] = pa.saves
        out["launches_a"] = launches
        device_ms = pa.log_trace("epoch 1 (3 decoder steps, cached features)", smi)
        out["busy"] = device_ms / (pa.prof[1])

        # run B: preempted by SIGTERM after the 7th decoder step (epoch 2,
        # batch 1), then resumed from state_preempt to the end
        with _TrainProbe(preempt_after=7):
            try:
                cli.train_main(argv("b"))
                raise AssertionError("run B: the train entry did not exit on SIGTERM")
            except SystemExit as e:
                code = e.code
        path = os.path.join(root, "logs_b", "ckp", "state_preempt")
        with np.load(path + ".npz") as f:
            meta = json.loads(bytes(f["__meta_json__"]).decode())
        _log(f"  run B: exit {code} after the 7th decoder step, state_preempt metadata {meta}")
        if code != 128 + signal.SIGTERM or (meta.get("phase"), meta.get("batch_done"), meta.get("epoch")) != \
                ("train", 1, 2):
            raise AssertionError(f"run B: exit {code}, metadata {meta}")
        run_b = cli.train_main(argv("b", "--resume", path))
        pa_final, pb_final = _train_params(run_a), _train_params(run_b)
        worst = max((x - y).abs().max().item() for x, y in zip(pb_final, pa_final))
        _log(f"  run B resumed to the end: largest difference from run A {worst:.6g} (decoder, EMA, "
             "discriminator and its statistics; bitwise must hold)")
        if worst != 0.0:
            raise AssertionError(f"run B: the resumed run differs from run A by up to {worst}")
        out["resume"] = ("bitwise", 0.0)

        # run C: LoRA (rank 2, alpha 4, lr 1e-4, remat none: the shipped
        # config's lora block), 2 epochs: a discriminator pass on the adapted
        # features at epoch 0, the finetune switch at epoch 1, the saves and
        # the validation at epoch 2
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with _TrainProbe(profile_epoch=1) as pc:
            run_c = cli.train_main(argv("c", model_cfg__lora__enable="True", train_cfg__max_epoch="2"))
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        lora_losses, dis_losses = pc.finite_losses("lora"), pc.finite_losses("dis")
        n_lora, n_dis = len(lora_losses), len(dis_losses)
        want = {**{k: 0 for k in counts}, "K1": (depth - 1) * pc.crop_batches(), "K6": (depth - 1) * pc.crop_batches(),
                "fwd_lse": (depth - 1) * (n_lora + n_dis), "bwd": (depth - 1) * n_lora}
        # the steps after the first (which pays for its first launches) and
        # outside the profiled epoch: each starts on an idle card, as in the
        # loop, where the pageable copy of the next batch's pixels waits for
        # the step before it
        timed = [t for t in pc.lora_times[1:] if not t[3]]
        ev_ms = [e0.elapsed_time(e1) for e0, e1, _, _ in timed]
        host_ms = [h * 1e3 for _, _, h, _ in timed]
        lora = run_c.train_loop.lora_params
        b_norm = torch.sqrt(sum(e["b"].float().square().sum() for layer in lora for e in layer.values())).item()
        _log(f"  run C (LoRA, bs{TRAIN_BATCH} 518px, 2 epochs): {secs:.3f} s host clock in all, {n_lora} LoRA steps, "
             f"{n_dis} discriminator steps on the adapted features, launches {launches} [{smi}]")
        _log(f"    LoRA losses {np.round(lora_losses, 5).tolist()}, adapter B-norm {b_norm:.6g}; LoRA step "
             f"({len(timed)} unprofiled steps after the first) median {np.median(ev_ms):.3f} ms by CUDA events, "
             f"{np.median(host_ms):.3f} ms "
             f"host clock; validations (s, crop calls) {pc.val}; saves "
             + ", ".join(f"{w} {s:.4f} s" for w, s in pc.saves) + f" [{smi}]")
        _check_launches("run C", launches, want)
        if (n_lora, n_dis) != (6, 3) or not b_norm > 0:
            raise AssertionError(f"run C: {n_lora} LoRA and {n_dis} discriminator steps, adapter B-norm {b_norm}")
        files = set(os.listdir(run_c.ckp_dir))
        need = {"lora_epoch2.safetensors", "backbone_merged_epoch2.safetensors", "state_epoch2.npz",
                "state_epoch2_lora.npz", "epoch2.safetensors"}
        if not need <= files:
            raise AssertionError(f"run C: files {sorted(files)}, missing {sorted(need - files)}")
        merged = FeatureExtractor(_Cfg(dict(run_c.cfg.dataset_cfg.feature_extractor_cfg), backbone_weights=os.path.join(
            run_c.ckp_dir, "backbone_merged_epoch2.safetensors")), device=dev, strict=True)
        images = load_image_batch_transform(val_paths[:2], (518, 518))
        f_merged, f_base = merged.extract(images), run_c.feature_extractor.extract(images)
        moved = float(np.abs(f_merged - f_base).max())
        _log(f"    the merged backbone in a FeatureExtractor: features of 2 val images differ from the base "
             f"backbone's by up to {moved:.6g} (max |base| {np.abs(f_base).max():.4g})")
        if not (np.isfinite(f_merged).all() and moved > 0):
            raise AssertionError(f"run C: merged-backbone features moved {moved}")
        # the profiler's own host cost inflates a LoRA epoch's wall several
        # times, so the busy share is the trace's device time per step over
        # the unprofiled steps' host clock
        device_ms = pc.log_trace("epoch 1 of run C (3 LoRA steps, the finetune epoch)", smi) / 3
        out["lora_busy"] = device_ms / np.median(host_ms)
        _log(f"    LoRA step: {device_ms:.3f} ms of device time (trace) per {np.median(host_ms):.3f} ms unprofiled "
             f"step, device busy {out['lora_busy']:.4f}; every step (events ms, host ms, profiled): "
             + ", ".join(f"({e0.elapsed_time(e1):.2f}, {h * 1e3:.2f}, {p})" for e0, e1, h, p in pc.lora_times)
             + f" [{smi}]")
        out.update(launches_c=launches, lora_ms=float(np.median(ev_ms)), lora_host_ms=float(np.median(host_ms)),
                   lora_val_s=[s for s, _ in pc.val], lora_save_s=pc.saves)

        # run D: run C preempted by SIGTERM after its 4th LoRA step (epoch 1,
        # batch 1), then resumed from state_preempt to the end: bit for bit
        # run C (the backward's dQ is summed in a fixed order)
        lora_argv = dict(model_cfg__lora__enable="True", train_cfg__max_epoch="2")
        with _TrainProbe(preempt_after=4):
            try:
                cli.train_main(argv("d", **lora_argv))
                raise AssertionError("run D: the train entry did not exit on SIGTERM")
            except SystemExit as e:
                code = e.code
        path = os.path.join(root, "logs_d", "ckp", "state_preempt")
        with np.load(path + ".npz") as f:
            meta = json.loads(bytes(f["__meta_json__"]).decode())
        _log(f"  run D (LoRA): exit {code} after the 4th LoRA step, state_preempt metadata {meta}")
        if code != 128 + signal.SIGTERM or (meta.get("phase"), meta.get("batch_done"), meta.get("epoch")) != \
                ("train", 1, 1):
            raise AssertionError(f"run D: exit {code}, metadata {meta}")
        run_d = cli.train_main(argv("d", "--resume", path, **lora_argv))

        def lora_params(run):
            return _train_params(run) + [t.detach().float().cpu() for t in tree_leaves(run.train_loop.lora_params)]

        worst = max((x - y).abs().max().item() for x, y in zip(lora_params(run_d), lora_params(run_c)))
        _log(f"  run D resumed to the end: largest difference from run C {worst:.6g} (decoder, EMA, discriminator "
             "and its statistics, LoRA adapters; bitwise must hold)")
        if worst != 0.0:
            raise AssertionError(f"run D: the resumed LoRA run differs from run C by up to {worst}")
        out["lora_resume"] = ("bitwise", 0.0)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    return out


# Phase N: CORAL stage 2 on configs/uscod/CORAL_dinov2.py as shipped apart
# from paths (val set TE-CAMO at batch 1, window size 3, window length 56,
# threshold 0.0015, no m-patches in its eval), over 16 synthetic val images
# at the COD sizes of phase K.
CORAL_VAL_IMAGES = 16
CORAL_CFG = "configs/uscod/CORAL_dinov2.py"


def phase_coral(seed: int, dev, smi: str, world: dict) -> dict:
    """Phase N: ``cli.lt_eval_main`` on the card twice (the first run builds
    the feature and grid-patch caches, the second reads them) with phase L's
    seeded stage-1 decoder and a seeded refiner file, its launches, outputs
    and rates; the refined logits of 4 images through the kernels against
    the f32 plain path; ``RefinePredictor`` with m-patches (the 756px
    forward, L 2917) and with ``quantize="int8"``, by their launches and
    img/s."""
    import shutil

    from PIL import Image

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.config import load_config
    from ucod_dpl_tpu_torch.data.dataset import grid_patch_arrays
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.engine.coral_loop import _make_refine, prepare_refine_inputs
    from ucod_dpl_tpu_torch.models.convert import params_to
    from ucod_dpl_tpu_torch.models.safetensors_io import load_decoder_checkpoint
    from ucod_dpl_tpu_torch.models.udlr import init_sparse_refiner, save_refiner_checkpoint
    from ucod_dpl_tpu_torch.serving import RefinePredictor
    from ucod_dpl_tpu_torch.utils.fileio import ImageIO

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work", "chip_smoke_coral")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "RefCOD")
    sizes = _write_cod_images(data, "TE-CAMO", CORAL_VAL_IMAGES, seed + 50)
    paths = sorted(glob.glob(os.path.join(data, "TE-CAMO", "im", "*.jpg")))
    ckpt = os.path.join(world["root"], "decoder.safetensors")  # phase L's seeded towers
    mc = load_config(CORAL_CFG).model_cfg
    ws, wl, th = mc.window_size, mc.window_length, mc.threshold
    decoder = params_to(load_decoder_checkpoint(ckpt)[0], dev)
    refine = _make_refine(ws, th)

    # the seeded refiner, its output bias moved to the 60th percentile of its
    # logits on 4 of the images (the run's own seeded backbone), so that the
    # refined masks mix foreground and background
    fe_cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = FeatureExtractor(fe_cfg, device=dev, seed=0, strict=False)
    l_images = load_image_batch_transform(paths[:4], (518, 518))
    grids = np.concatenate([grid_patch_arrays(ImageIO.read_image(p, "RGB"), (518, 518), ws) for p in paths[:4]])
    refiner = init_sparse_refiner(seed + 3, SERVE_DIM)
    with torch.inference_mode():
        h = fe.extract(grids)
        logits = refine(params_to(refiner, dev), *prepare_refine_inputs(
            decoder, fe.extract(l_images), h.reshape(4, ws ** 2, *h.shape[1:]), None, wl))
    refiner["ge"]["fuser2"]["b"] -= torch.quantile(logits.flatten().float().cpu(), 0.6)
    del fe
    refiner_path = os.path.join(root, "refiner.safetensors")
    save_refiner_checkpoint(refiner_path, refiner)
    argv = ["-c", CORAL_CFG, "--load_from", ckpt, "--refiner_path", refiner_path, "--datasets", "TE-CAMO",
            "--device", str(dev), "--work_dir", os.path.join(root, "work_dir"), "--opts", "dataset_cfg.dataset_dir", data,
            "dataset_cfg.cache_dir", os.path.join(root, "cache"), "log_cfg.log_path", os.path.join(root, "logs")]
    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    per_chunk = max(1, EVAL_CACHE_BATCH // ws ** 2)  # LRDataset's grid-patch chunk: images per extractor call
    out = {}
    for run in ("first", "second"):
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        runner = cli.lt_eval_main(argv)["TE-CAMO"]
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        ev, ds = runner.evaluator, runner.val_dataset
        # the first run's cache builds (8 images a feature batch, 9 crops an
        # image a grid batch), and two forwards (the grid and the l pass) for
        # each centre-crop fallback
        forwards = 2 * ev.crops + ((-(-CORAL_VAL_IMAGES // EVAL_CACHE_BATCH) + -(-CORAL_VAL_IMAGES // per_chunk))
                                   if run == "first" else 0)
        want = {**{k: 0 for k in counts}, "K1": 11 * forwards, "K6": 11 * forwards}
        _log(f"  lt_eval {run} run: {secs:.3f} s host clock in all, feature cache "
             + (f"{ds.build_seconds:.3f} s" if ds.build_seconds else "read")
             + ", grid-patch cache " + (f"{ds.patch_build_seconds:.3f} s" if ds.patch_build_seconds else "read")
             + f", eval sweep {ev.seconds:.3f} s ({CORAL_VAL_IMAGES / ev.seconds:.2f} img/s; device passes "
             f"{ev.refine_seconds:.3f} s), {ev.crops} centre-crop fallbacks, launches {launches} [{smi}]")
        _check_launches(f"lt_eval {run} run", launches, want)
        result = ev.result
        if set(result) != set(EVAL_KEYS) or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in result.values()):
            raise AssertionError(f"lt_eval {run} run: result {result}")
        if result["mIOU"] == 0.0:
            raise AssertionError(f"lt_eval {run} run: no foreground predicted (mIOU 0): {result}")
        _log(f"    result {result}")
        out[run] = dict(secs=secs, launches=launches, eval_s=ev.seconds, crops=ev.crops, result=result,
                        build_s=(ds.build_seconds or 0.0) + (ds.patch_build_seconds or 0.0))
    if out["second"]["result"] != out["first"]["result"]:
        raise AssertionError(f"lt_eval from the cache: {out['second']['result']} != {out['first']['result']}")
    patch = ds.caches.get("patch")
    entries = [patch.read(i) for i in range(CORAL_VAL_IMAGES)]
    if any(e.shape != (ws ** 2, 37, 37, SERVE_DIM) or e.dtype != np.float32 or not np.isfinite(e).all()
           for e in entries):
        raise AssertionError("grid-patch cache: an entry of the wrong shape or dtype, or not finite")
    masks = sorted(os.listdir(os.path.join(root, "logs", "preds", "TE-CAMO")))
    got_sizes = [Image.open(os.path.join(root, "logs", "preds", "TE-CAMO", m)).size[::-1] for m in masks]
    if len(masks) != CORAL_VAL_IMAGES or got_sizes != sizes:
        raise AssertionError(f"lt_eval masks: {masks[:3]}... at {got_sizes[:3]}...")
    _log(f"  caches: {CORAL_VAL_IMAGES} finite float32 grid-patch entries of {entries[0].shape}; {len(masks)} masks "
         "at their ground-truth sizes")

    # accuracy on 4 images: the refiner (f32) on the cached features (the
    # kernels, bf16) and on the bf16 plain path's, against the f32 plain path's
    fe = runner.feature_extractor
    f32 = FeatureExtractor(fe.fe_cfg, device=dev, compute_dtype=torch.float32, seed=0, strict=False)
    feats = {"kernels": (np.stack([ds.caches.get("features").read(i) for i in range(4)]), np.stack(entries[:4]))}
    for name, ex, dtype in (("f32 plain", f32, torch.float32), ("bf16 plain", fe, torch.bfloat16)):
        l = _features_plain(ex, l_images, ex.params, dtype).cpu().numpy()
        h = np.concatenate([_features_plain(ex, grids[i : i + 12], ex.params, dtype).cpu().numpy()
                            for i in range(0, len(grids), 12)])
        feats[name] = (l, h.reshape(4, ws ** 2, *h.shape[1:]))
    del f32
    refiner_dev = params_to(refiner, dev)
    refined = {}
    with torch.inference_mode():
        for name, (l, h) in feats.items():
            l_feat, h_feat, preds = prepare_refine_inputs(decoder, l, h, None, wl)
            refined[name] = refine(refiner_dev, l_feat, h_feat, preds)
    ref = refined["f32 plain"]
    err = (refined["kernels"] - ref).abs().max().item()
    err_plain = (refined["bf16 plain"] - ref).abs().max().item()
    bound = 1.5 * err_plain + 1e-3
    _log(f"  refined logits of 4 images vs the f32 plain path: max_abs_err {err:.6g}, bf16 plain {err_plain:.6g}, "
         f"bound {bound:.6g} (max |f32| {ref.abs().max().item():.4g})")
    if not (np.isfinite(err) and err <= bound):
        raise AssertionError(f"refined logits error {err} exceeds {bound}")
    out["err"], out["err_plain"] = err, err_plain

    # serving: RefinePredictor with m-patches (l at 518px, the 3 x 3 grid, the
    # 2 x 2 m-patches of one 756px forward, L 2917) on the eval's extractor,
    # then from the shipped config with the int8 backbone
    def serve(rp, what):
        calls, fallbacks = [], []
        extract, cropped = rp.fe.extract, rp._refine_cropped
        rp.fe.extract = lambda images: calls.append(np.shape(images)) or extract(images)
        rp._refine_cropped = lambda img: fallbacks.append(img) or cropped(img)
        try:
            rp.predict(paths[4:8])  # warm-up
            for fn in counts.values():
                fn.launches = 0
            calls.clear(), fallbacks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masks = rp.predict(paths[:4])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            del rp.fe.extract, rp._refine_cropped
        launches = {k: fn.launches for k, fn in counts.items()}
        _log(f"  RefinePredictor ({what}): 4 images in {secs * 1e3:.1f} ms host clock ({4 / secs:.2f} img/s), "
             f"extractor calls {calls}, {len(fallbacks)} centre-crop fallbacks, launches {launches} [{smi}]")
        if len(masks) != 4 or any(m.shape != (518, 518) or not np.isin(m, (0.0, 1.0)).all() for m in masks):
            raise AssertionError(f"RefinePredictor ({what}): masks {[m.shape for m in masks]}")
        return len(calls), launches, 4 / secs, calls

    rp = RefinePredictor(fe, load_decoder_checkpoint(ckpt)[0], refiner, image_size=(518, 518), window_size=ws,
                         window_length=wl, threshold=th, use_m_patches=True, max_batch=4)
    n_calls, launches, img_s, calls = serve(rp, "bf16, m-patches")
    if (4, 756, 756, 3) not in calls:
        raise AssertionError(f"RefinePredictor with m-patches: no 756px forward in {calls}")
    _check_launches("RefinePredictor bf16", launches, {**{k: 0 for k in counts}, "K1": 11 * n_calls,
                                                       "K6": 11 * n_calls})
    out.update(serve_launches=launches, serve_img_s=img_s)
    del rp
    rp8 = RefinePredictor.from_config(CORAL_CFG, ckpt, refiner_path, device=dev, strict=False, quantize="int8")
    n_calls, launches, img_s, _ = serve(rp8, "int8, the shipped config: no m-patches")
    _check_launches("RefinePredictor int8", launches, {**{k: 0 for k in counts}, **{k: 11 * n_calls for k in
                                                                                   ("K1", "K8", "K9", "K10")}})
    out.update(serve_int8_launches=launches, serve_int8_img_s=img_s)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights and inputs")
    args = parser.parse_args(argv)

    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k1_err = phase_k1(gen, dev)
    k6_err = phase_k6(gen, dev)
    grad_err = phase_attention_grad(gen, dev)
    fe, decoder = _serving_model(args.seed, dev)
    launches = phase_serving(fe, decoder, args.seed)
    phase_composed(fe, decoder, args.seed)
    times = phase_timing(fe, decoder, gen)
    del fe
    lora_run = phase_lora(args.seed, dev)
    train_launches, peak_gib = lora_run["launches"], lora_run["peak_gib"]
    grad_rel = phase_lora_grads(args.seed, dev)
    train_times = phase_train_timing(lora_run, gen)
    lora_ms, lora_plain_ms = train_times["lora_step"]
    del lora_run
    torch.cuda.empty_cache()
    int8_err = phase_int8_kernels(gen, dev)
    fe8 = _serving_model(args.seed, dev, quantize="int8")[0]
    int8_launches = phase_int8_serving(fe8, decoder, args.seed)
    int8_composed_err = phase_int8_composed(fe8, decoder, args.seed)
    int8_times = phase_int8_timing(fe8, decoder, gen)
    k5_err = phase_k5(gen, dev)
    k5_times = phase_k5_timing(gen, dev)
    tp = phase_tp(args.seed, dev, _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None))
    k7 = phase_k7(gen, dev, fe8)
    del fe8
    torch.cuda.empty_cache()
    evalk = phase_eval(args.seed, dev, smi)
    torch.cuda.empty_cache()
    pl = phase_pseudo_labels(args.seed, dev, smi)
    torch.cuda.empty_cache()
    train = phase_train(args.seed, dev, smi, pl)
    torch.cuda.empty_cache()
    coral = phase_coral(args.seed, dev, smi, pl)
    _log(json.dumps({
        "fg_logits_live_img_per_s": times["fg_logits_live_img_per_s"],
        "fg_logits_live_plain_img_per_s": times["fg_logits_live_plain_img_per_s"],
        "lora_step_ms": lora_ms, "lora_step_plain_ms": lora_plain_ms,
        "lora_step_remat_layer_ms": train_times["lora_step_remat_layer"],
        "lora_grad_rel_diff": grad_rel, "lora_step_peak_gib": peak_gib,
        "int8_fg_logits_live_img_per_s": 16e3 / int8_times["fwd int8 kernels"],
        "int8_fg_logits_live_plain_img_per_s": 16e3 / int8_times["fwd int8 plain"],
        "int8_whole_mlp_img_per_s": 16e3 / int8_times["fwd int8 kernels, whole MLP"],
        "bf16_fg_logits_live_img_per_s_same_process": 16e3 / int8_times["fwd bf16 kernels"],
        "int8_composed_max_abs_err": int8_composed_err,
        "tp4_extract_ms": tp["TP model=4 extract"], "unsharded_extract_ms": tp["unsharded extract"],
        "tp4_forward_ms": tp["TP model=4 forward"], "unsharded_forward_ms": tp["unsharded forward"],
        "tp4_features_max_abs_err": tp["err model=4"], "tp2_features_max_abs_err": tp["err data=2 x model=2"],
        "k6_gemm_alone_ms": times["K6_gemm_alone"],
        "k8_same_x_ms": int8_times["K8_vs_K6"][0], "k6_same_x_ms": int8_times["K8_vs_K6"][1],
        "k8_same_x_device_ms": int8_times["K8_vs_K6_device"][0],
        "k6_same_x_device_ms": int8_times["K8_vs_K6_device"][1],
        "int_mm_k8_shape_ms": int8_times["int_mm_qkv"], "int_mm_k9_shape_ms": int8_times["int_mm_fc1"],
        "int_mm_k8_shape_device_ms": int8_times["int_mm_qkv_device"],
        "int_mm_k9_shape_device_ms": int8_times["int_mm_fc1_device"],
        "k5_per_head_ms": k5_times["per-head"]["ms"], "k5_per_head_sdpa_ms": k5_times["per-head"]["library_ms"],
        "bf16_plain_features_max_abs_err": tp["err_plain"],
        "k7_mlp_half_ms": k7["mlp_half_fused_ms"], "composed_mlp_half_ms": k7["mlp_half_composed_ms"],
        "k7_device_ms": k7["device_ms"]["K7"], "k7_composed_up_device_ms": k7["device_ms"]["composed_up"],
        "k11_ms": int8_times["K11"][0], "k11_split_half_ms": int8_times["K11_vs_split"][1],
        "k11_device_ms": int8_times["K11_vs_split_device"][0],
        "k11_split_half_device_ms": int8_times["K11_vs_split_device"][1],
        "eval_cache_build_img_per_s": EVAL_IMAGES / evalk["first"]["build_s"],
        "eval_img_per_s": EVAL_IMAGES / evalk["first"]["eval_s"],
        "eval_from_cache_img_per_s": EVAL_IMAGES / evalk["second"]["eval_s"],
        "eval_look_twice_crops": evalk["first"]["crops"], "eval_device_busy": evalk["busy"],
        "eval_cached_features_max_abs_err": evalk["err"],
        "train_cache_build_img_per_s": train["cache_build_img_per_s"],
        "train_decoder_steps_per_s": train["decoder_steps_per_s"], "train_dis_steps_per_s": train["dis_steps_per_s"],
        "train_epoch_device_busy": train["busy"], "train_val_s": train["val_s"],
        "train_resume": train["resume"][0], "train_resume_max_abs_diff": train["resume"][1],
        "lora_train_resume": train["lora_resume"][0],
        "pseudo_label_img_per_s": pl["img_per_s"], "pseudo_label_device_busy": pl["busy"],
        "pseudo_label_cls_attention_max_abs_err": pl["err_cls_attention"],
        "pseudo_label_key_tokens_max_abs_err": pl["err_key_tokens"], "pseudo_label_mask_differ": pl["mask_differ"],
        "coral_eval_img_per_s": CORAL_VAL_IMAGES / coral["first"]["eval_s"],
        "coral_eval_from_cache_img_per_s": CORAL_VAL_IMAGES / coral["second"]["eval_s"],
        "coral_cache_build_img_per_s": CORAL_VAL_IMAGES / coral["first"]["build_s"],
        "coral_refined_max_abs_err": coral["err"], "coral_centre_crop_fallbacks": coral["first"]["crops"],
        "refine_predictor_m_patches_img_per_s": coral["serve_img_s"],
        "refine_predictor_int8_img_per_s": coral["serve_int8_img_s"],
        "lora_entry_step_ms": train["lora_ms"], "lora_entry_step_host_ms": train["lora_host_ms"],
        "lora_entry_epoch_device_busy": train["lora_busy"],
        "batch": 16, "image": 518, "dtype": "bfloat16",
    }))
    # each kernel's bound at the shape it was timed at (bs16 L1370, 12 heads
    # of 64, D 768, F 3072; K5 at the TP shards' 48 heads): bf16 tensors and
    # int8 weights moved once, the f32 vectors (under 40 KB) left out; K3/K4
    # counts the five products of 2 L^2 d per head a flash backward from the
    # log-sum-exp needs (S, dP, dV, dK, dQ), which the one-pass kernel runs
    b, l, d, f = 16, 1370, SERVE_DIM, MLP_DIM
    rows, bh = b * l, b * NUM_HEADS
    bounds = {
        "K1": _attention_bound(bh, l, 64), "K2": _attention_bound(bh, l, 64, lse=True),
        "K3": _attention_bound(bh, l, 64, matmuls=5, tensors=8, lse=True),
        "K5": _attention_bound(48, l, 64),
        "K6": _bound(2.0 * rows * d * 3 * d, (4 * rows * d + 3 * d * d) * 2, PEAK_BF16),
        "K7": _bound(2.0 * rows * d * f, (rows * d + rows * f + f * d) * 2, PEAK_BF16),
        "K8": _bound(2.0 * rows * d * 3 * d, 4 * rows * d * 2 + 3 * d * d, PEAK_INT8),
        "K9": _bound(2.0 * rows * d * f, rows * d * 2 + rows * f + rows * 4 + f * d, PEAK_INT8),
        "K10": _bound(2.0 * rows * d * d, 2 * rows * d * 2 + d * d, PEAK_INT8),
        "K11": _bound(4.0 * rows * d * f, 2 * rows * d * 2 + 2 * f * d, PEAK_INT8),
    }
    bounds["K4"] = bounds["K3"]

    # each kernel's launches on the train entry's runs (phase L): run A
    # (cached features) and run C (LoRA); on the pseudo-label generator
    # (phase M), the CORAL eval's first run and the RefinePredictor calls
    # (phase N)
    train_key = {"K2": "fwd_lse", "K3": "bwd", "K4": "bwd"}

    def entry(kid, name, source, replaces, launches, err, ms, plain_ms, library_ms=None, **device):
        key = train_key.get(kid, kid)
        return {"name": f"{kid} {name}", "route": "cuda", "source": f"ucod_dpl_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1], "library_ms": library_ms,
                "train_launches": train["launches_a"].get(key, 0), "lora_train_launches": train["launches_c"].get(key, 0),
                "pseudo_label_launches": pl["launches"].get(key, 0),
                "coral_eval_launches": coral["first"]["launches"].get(key, 0),
                "refine_serving_launches": coral["serve_launches"].get(key, 0),
                "refine_int8_launches": coral["serve_int8_launches"].get(key, 0), **device}

    attn, fused = "ucod_dpl_tpu/ops/attention.py", "ucod_dpl_tpu/ops/fused_layers.py"
    _log(json.dumps({"kernels": [
        # K1 and K6: launches on the eval entry's first run (cache build and
        # crop pass), beside those of the serving phase
        entry("K1", "packed attention forward", "attention_fwd.cu", f"{attn}:87",
              evalk["first"]["launches"]["K1"], k1_err, *times["K1"], times["sdpa_fwd"],
              serving_launches=launches["K1"]),
        entry("K2", "attention forward with log-sum-exp", "attention_fwd.cu", f"{attn}:309",
              train_launches["fwd_lse"], grad_err["fwd_lse"], *train_times["fwd_lse"], times["sdpa_fwd"]),
        entry("K3", "attention backward from the log-sum-exp (one backward with K4)", "attention_bwd.cu",
              f"{attn}:440", train_launches["bwd"], grad_err["bwd"], *train_times["bwd"], train_times["sdpa_bwd"]),
        entry("K4", "KV-blocked attention backward (one backward with K3)", "attention_bwd.cu",
              f"{attn}:684,716", train_launches["bwd"], grad_err["bwd"], *train_times["bwd"], train_times["sdpa_bwd"]),
        # K5's path is the TP model=4 extract, where the packed forward runs
        # 3 heads a shard: its launches are that run's, its time the shard's shape's
        entry("K5", "per-head attention forward (the forward kernel at 3 heads a shard)", "attention_fwd.cu",
              f"{attn}:30", tp["launches model=4"]["K1"], k5_err, *(k5_times["tp-shard"][key] for key in
                                                                     ("ms", "plain_ms", "library_ms"))),
        entry("K6", "fused LayerNorm + q/k/v", "layernorm_qkv.cu", f"{fused}:33",
              evalk["first"]["launches"]["K6"], k6_err, *times["K6"], serving_launches=launches["K6"]),
        entry("K7", "fused LayerNorm + fc1 + GELU (K6's main kernel)", "layernorm_qkv.cu", f"{fused}:86",
              k7["launches"], k7["err"], k7["ms"], k7["plain_ms"], device_ms=k7["device_ms"]["K7"],
              plain_device_ms=k7["device_ms"]["plain"]),
        # ms, plain_ms by events as every kernel's; device_ms, plain_device_ms
        # the card's own time (phase G)
        *(entry(k, name, "int8_linear.cu", f"{fused}:{line}", int8_launches[k], int8_err[k], *int8_times[k],
                **dict(zip(("device_ms", "plain_device_ms"), int8_times[f"{k}_device"])))
          for k, name, line in (("K8", "int8 LayerNorm + quantize + q/k/v", 160),
                                ("K9", "int8 LayerNorm + quantize + fc1 + GELU + requantize", 218),
                                ("K10", "int8 quantize + out-projection", 479),
                                ("K11", "int8 whole MLP half", 327))),
    ]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
