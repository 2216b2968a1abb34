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
     then CLS attention under TP: ``extract_with_attention`` (the
     pseudo-label generator's call) at 224px bs16 under ``{"data": 1,
     "model": 4}``: the packed forward 44 times, K6 never; the CLS attention
     and key tokens no further from the f32 unsharded plain path than 1.5 x
     the bf16 unsharded plain path's error + 1e-3; each path's background
     reference patch (an argmin of weighted CLS attention) within twice the
     bf16 noise bound of the f32 minimum, and, on the images where TP and the
     unsharded kernel path pick the same patch (at least 3 in 4), the
     generator's masks differing on at most 0.002 of the pixels;
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
     the cache.  Every image of each run is scored by the native scorer
     (``native/metrics_kernel.cpp``, counted in
     ``utils/metrics.native_scored``); with ``--numpy-scorer``, a third run
     from the cache under ``UCOD_NATIVE_METRICS=0`` scores them in NumPy, to
     metrics within 1e-9, its metric seconds beside the native scorer's
     (the CPU tests hold the two scorers' parity).  The kernels
     line's K1/K6 launches are this phase's first run's (the serving
     phase's beside them);
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
     ``refine_serving_launches``, ``refine_int8_launches``);
  O. CORAL stage-2 training: ``ucod_dpl_tpu_torch.cli.lt_train_main`` on
     configs/uscod/CORAL_dinov2.py as shipped (batch 2, window size 3,
     length 56, m-patches for the train set, lr0 1e-4, gamma 0.95 every 2
     epochs, EMA from epoch 1 at 0.70, validation every 4 epochs from 4)
     apart from paths and 8 epochs cut to 4, with phase L's decoder
     (``--load_from``) and the Runner's seeded refiner, over 16 of phase M's
     train images (with ground truth) and their pseudo-labels and 8 val
     images.  Run A: K1 and K6 launch 11 times per backbone forward of the
     train caches (features, grid patches, 756px m-patches, L 2917) and the
     val caches and of the validation's centre-crop fallbacks, nothing
     else; 32 finite losses, a moving refiner, ``epoch1..4.safetensors`` and
     ``epoch1..4_ema.safetensors`` (the EMA a copy at epoch 1, its own
     after), the epoch-4 validation's metrics finite in [0, 1], and
     ``lt_eval`` on ``epoch4.safetensors``; cache-build img/s, steps/s by
     host clock, step ms by CUDA events, a step's peak device memory, the
     device's busy share of one epoch and its top operations.  Run B: run A
     with SIGTERM after its 10th step: exit 128 + 15, one
     ``epoch1_preempt.safetensors``, its ``epoch1.safetensors`` equal to run
     A's bit for bit (cuDNN deterministic), and a restart with
     ``--refiner_path`` on the preempt file to the end.  The kernels line
     gives each kernel's launches in run A and in phase I's CLS call
     (``coral_train_launches``, ``tp_cls_launches``);
  P. data parallel over ``torch.distributed``, each rank a subprocess of
     this script (``--dp-worker``) with its kernel counts set to 0 before
     its entry runs.  P1: phase L's run A (``cli.train_main``, the caches
     read) under ``UCOD_DIST=1 WORLD_SIZE=1``, a group of one (NCCL default
     group, gloo host group), which is a plain run: 12 decoder and 6
     discriminator steps, no collective, K1 and K6 11 times per LookTwice
     crop call and nothing else; the final state within rtol 1e-4 / atol
     5e-6 of run A's (the learnable embeddings by drift), bitwise equal to
     a second P1 run and to the same subprocess without a group; decoder
     steps/s beside run A's.  P2: phase K's
     ``cli.eval_main`` over 2 ranks on the one card (``RANK`` 0/1,
     ``LOCAL_RANK`` 0), a fresh cache directory: rank 0 alone builds the
     cache (K1/K6) and writes its index; 16 images a rank, the crop calls
     of both adding up to phase K's; the metrics equal on both ranks and
     within 1e-12 of phase K's; each rank's launches, eval img/s.  P3
     (only with 2 cards; otherwise the script says why it did not run;
     ``--only-p3`` runs it alone, after phase M's data and phase L's
     checkpoint): P1 over 2 ranks on 2 cards, the gradient buckets and the
     batch-norm moments over NCCL, each rank first checking those
     collectives against one process's arithmetic; the ranks' final states
     bitwise equal, one all-reduce an optimizer step.  The
     kernels line gives each kernel's launches in P1 and in P2's two ranks
     (``dp_train_launches``, ``dp_eval_launches``).
  Q. sequence parallelism (``parallel/sp.py``), after phase J, on one card
     named four times: Q0 K2 with an f32 output and K3/K4 with f32 outputs
     against their plain versions at the ring's chunk shapes ((4, 730, 768)
     at 756px, (16, 343, 768) at 518px) with the chunks' key bounds (730
     and 727, 343 and 341), timed at the 756px chunk beside SDPA; Q1
     ``FeatureExtractor`` over ``{"data": 1, "seq": 4}`` at 756px bs4 (L
     2917 padded to 2920) and 518px bs16 (1370 to 1372), and over
     ``{"data": 1, "model": 2, "seq": 2}`` at 756px: K2 176 (88) times a
     forward and nothing else, err <= 1.5 * err(bf16 unsharded plain) +
     1e-3 against the f32 unsharded plain path, ms against the unsharded
     extract, interleaved; Q2 three LoRA steps (``make_lora_train_step(
     sp_shard=)``) at 756px bs4 over ``{"seq": 4}``, remat none: 176 K2 and
     176 K3/K4 launches a step, the third step's gradients within 0.1 of
     the unsharded kernel step's, two runs bitwise equal, step ms and peak
     memory against the unsharded step; Q3 remat "dots" at bs16 518px:
     gradients within 0.1 of "none", 22 K2 and 11 K3/K4 launches a step,
     ms and peak memory of none, layer and dots, interleaved.  The kernels
     line gives K2's and K3/K4's launches in Q1's seq=4 756px forward and
     in a Q2 step (``sp_launches``, ``sp_lora_launches``) and their chunk
     times (``sp_chunk_*``).  ``--only-q4`` (four cards) runs Q1 and Q2
     over ``cuda:0..3`` and phase I's ``{"model": 4}`` over four cards
     against one card, with each card's peak memory, alone.
  R. (``--only-r4``, four cards, alone) sequence parallelism across
     processes: ranks are this script run as ``--sp-worker SPEC``, one
     process per card over NCCL (R1, R2) or per two cards (R3), the ring
     between processes by NCCL send/recv.  R1: the ring alone over
     ``{"seq": 4}`` at the 756px bs4 chunk (4, 730, 768) bf16, forward and
     backward: 4 K2 and 4 K3/K4 launches a rank, every rank's output and
     dq/dk/dv bitwise the one-process ring's on the same inputs (rank 0's
     card named four times); ms of the process ring, the one-process ring
     on one card and on four.  R2: ``make_lora_train_step(sp_shard=)`` on
     ``{"seq": 4}`` over 4 processes at 756px bs4 (full-width dinov2-base,
     bf16, remat none), three steps: finite losses, moving adapters, 44 K2
     and 44 K3/K4 launches a rank a step and nothing else; ranks' states
     bitwise equal; the third step's reduced gradients within 0.1 of the
     unsharded kernel step's from the same state (phase B's rule; in this
     process, after the ranks), and within about 10x the H100's measured
     difference (3e-3 decoder + LoRA, 2e-2 LoRA alone); step ms by CUDA events and host wall, ring
     bytes, gradient all-reduces, a trace (busy share, NCCL kernels) and
     each card's peak memory per rank.  R3: the same over ``{"data": 2,
     "seq": 2}`` on 2 processes of 2 cards at bs8 (the JAX multi-process
     test's layout: the ring inside each process, the data axis across).
     Then the unsharded step at bs4 and bs8 and the one-process SP step
     over the four cards (one process driving every card) at bs4, with
     their peak memory.
  S. (after phase P) the serving forward's two fusion prototypes, on no
     product path: K12 (``attention_outproj_residual``: attention +
     out-projection + bias + layerscale + residual in one kernel) at bs16
     L1370 and K13 (``patch_embed``: the 14 x 14 patch embed as one im2col
     GEMM + bias, with and without the position rows) at bs16 518px, each
     once with its count set to 0 just before (1 and 2 launches), outputs
     pre-filled with NaN, against their plain versions; then K12 at B1 L65
     and K13 at B2 224px; timing: K12 against its plain version, the
     composed path the port runs (K1, ``dense``, the layerscale and the
     residual in bf16, models/dino.py) and the cuBLAS out-projection alone;
     K13 against its plain version, ``_embed``'s convolution path (a
     permuted bf16 copy, cuDNN, flatten/transpose, the bias add; + the
     position rows) and one ``F.conv2d`` with its bias (``library_ms``),
     by events and by the card's own time.
  T. (after phase S) the K1 variants that port the eight TPU attention
     prototypes (``tools/attention_ab.py``: ``SITES``, on no product path):
     all built from this checkout in parallel, each launched once at bs16
     L1370 (the row variants, fwd_rows64 and fwd_rows192, also at bs8
     L2917, bench_attention_756.py's shape) with the counts at 0 just
     before, into NaN-filled outputs, held against its plain function
     (K1's, or the diagnostics' and the constant shift's own) within K1's
     bound, and timed against K1 by the card's own time (interleaved K1,
     variant, variant, K1), beside its plain function and one
     ``scaled_dot_product_attention`` call; one kernels-line entry per
     prototype site.
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
import dataclasses
import functools
import glob
import json
import math
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
# Phase S.  K12 against its plain version: both round each head's output
# to bf16 (the plain version's softmax by exp, the kernel's by ex2.approx,
# sums in other orders) and the result x + (attn Wo^T + bo) ls once.  The
# residual x (N(0, 1), max about 5.8) sets max|out| but is passed through,
# so the part K12 computes, out - x, is held: its difference from the plain
# version's within K1's bound, 2^-6 of max|plain - x|, plus, per element,
# one bf16 ulp of the larger of |out| and |plain| for the final rounding
# (two roundings of nearly equal values land on the same or adjacent bf16
# values).  A bound of 2^-6 of max|out| would be about 2 standard
# deviations of out - x and let a dropped head through.  On an H100 the
# worst element takes 0.76 of this bound at bs16 L1370 (one ulp at |out|
# in [4, 8); max|plain - x| 0.633) and 0.18 at B1 L65.
# K13: both round the pixels to bf16 (exactly the same values) and the f32
# sum once; only the order of the f32 additions differs, which moves a
# result across a bf16 rounding boundary at most: one bf16 ulp of
# max|plain| (2^-7 of it at most).
K12_TOL = 2.0 ** -6
K13_TOL = 2.0 ** -7
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


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``t``, f32: 2^(e - 8) for |t| in
    [2^(e - 1), 2^e)."""
    e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126)).exponent
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _check_residual(name: str, got: torch.Tensor, ref: torch.Tensor, x: torch.Tensor, tol: float) -> float:
    """``got`` against ``ref``, outputs x + f(...) rounded to bf16 once, on
    the part they compute: |got - ref| = |(got - x) - (ref - x)| within
    ``tol`` times max|ref - x|, plus one bf16 ulp per element of the larger
    of |got| and |ref| (the final rounding).  Returns max|got - ref|."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    scale = (r - x.float()).abs().max().item()
    bound = tol * scale + _bf16_ulp(torch.maximum(g.abs(), r.abs()))
    err, worst = diff.max().item(), (diff / bound).max().item()
    _log(f"  {name}: max_abs_err {err:.6g}, at most {worst:.4f} of its bound (2^{math.log2(tol):.0f} of "
         f"max |plain - x| {scale:.4g} + one bf16 ulp of the output; max |plain| {r.abs().max().item():.4g})")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds 2^{math.log2(tol):.0f} max|plain - x| + 1 ulp "
                             f"({worst} of the bound)")
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


def _lora_setup(seed: int, dev, batch: int, size: int = 518):
    """A full-width dinov2-base with float32 q/k/v masters (seeded random
    weights), fresh decoder/EMA/discriminator state and adapters, and seeded
    ``size``-px pixels and 68x68 pseudo-labels of ``batch`` images."""
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
    pixels = torch.from_numpy(rng.standard_normal((batch, size, size, 3)).astype(np.float32)).to(dev)
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


def _grads(loss_fn, state, lora, fe, pixels, labels, epoch: float = 2.0):
    """The decoder's and the adapters' gradients of one loss, each group
    flattened into one f32 vector."""
    from ucod_dpl_tpu_torch.models.convert import tree_leaves

    groups = (tree_leaves(state.decoder), tree_leaves(lora))
    loss, _ = loss_fn(state, lora, fe.params, pixels, labels, epoch, 1.0)
    grads = iter(torch.autograd.grad(loss, groups[0] + groups[1], allow_unused=True))
    # leaves first in the zip: it stops on them without taking the next
    # group's first gradient
    return [torch.cat([(torch.zeros_like(t) if g is None else g).float().flatten()
                       for t, g in zip(leaves, grads)]) for leaves in groups]


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


def phase_tp_cls(seed: int, dev, fe_cfg, smi: str) -> dict:
    """Phase I, CLS attention: ``extract_with_attention`` (the pseudo-label
    generator's call) at 224px, bs16, under ``{"data": 1, "model": 4}`` on
    one card named four times: K1 44 launches (11 layers x 4 shards), K6
    none; CLS attention and key tokens against the f32 unsharded plain
    path beside the bf16 unsharded plain path; the generator's masks against
    those of the unsharded kernel path (see below for its reference patch)."""
    import shutil

    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.dino import dino_forward
    from ucod_dpl_tpu_torch.ops.pseudo_label import reference_scores
    from ucod_dpl_tpu_torch.parallel import build_mesh

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work", "chip_smoke_tp_cls")
    shutil.rmtree(root, ignore_errors=True)
    _write_cod_images(root, "TP", PL_BATCH, seed + 70, labels=False)
    images = load_image_batch_transform(sorted(glob.glob(os.path.join(root, "TP", "im", "*.jpg"))), (PL_SIZE, PL_SIZE))
    fe = FeatureExtractor(fe_cfg, mesh=build_mesh({"data": 1, "model": 4}, devices=[dev] * 4), seed=seed, strict=False)
    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks, _, attn = fe.extract_with_attention(images)
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    depth = fe.config.num_layers
    _log(f"TP CLS attention: extract_with_attention at {PL_SIZE}px, bs{PL_BATCH}, {fe.compute_dtype}, mesh "
         f"{{'data': 1, 'model': 4}} on one card: {secs:.3f} s host clock (first call), cls_attention {attn.shape}, "
         f"launches {launches} [{smi}]")
    _check_launches("TP extract_with_attention", launches, {**{k: 0 for k in counts}, "K1": 4 * (depth - 1)})

    f32 = FeatureExtractor(fe_cfg, device=dev, compute_dtype=torch.float32, seed=seed, strict=False)
    unsharded = FeatureExtractor(fe_cfg, device=dev, seed=seed, strict=False)
    px = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        def plain(params, dtype):
            out = dino_forward(params, px, fe.config, compute_dtype=dtype, plain=True, want_cls_attention=True)
            return out["cls_attention"].float(), out["key_tokens"].float()

        ref, bf16_plain = plain(f32.params, torch.float32), plain(fe.params, torch.bfloat16)
        tp = (torch.from_numpy(attn).to(dev), torch.from_numpy(toks).to(dev))
        u_toks, _, u_attn = unsharded.extract_with_attention(images)
        kern = (torch.from_numpy(u_attn).to(dev), torch.from_numpy(u_toks).to(dev))
    del f32
    out = {"launches": launches}
    for i, what in enumerate(("cls_attention", "key_tokens")):
        err = (tp[i] - ref[i]).abs().max().item()
        err_plain = (bf16_plain[i] - ref[i]).abs().max().item()
        bound = 1.5 * err_plain + 1e-3
        _log(f"  TP {what} vs f32 unsharded plain: max_abs_err {err:.6g}, bf16 unsharded plain {err_plain:.6g}, bound "
             f"{bound:.6g}; unsharded kernels {(kern[i] - ref[i]).abs().max().item():.6g}")
        if not (np.isfinite(err) and err <= bound):
            raise AssertionError(f"TP CLS attention: {what} error {err} exceeds {bound}")
        out[f"err_{what}"] = err
    # The generator's masks hang on one argmin: the background reference is
    # the patch of least weighted CLS attention (ops/pseudo_label.py::
    # reference_scores), and where the two least weighted patches lie within
    # bf16 noise of each other a path may pick either, and that image's mask
    # changes wholesale.  So: each path's pick
    # must lie, by the f32 path's sums, within twice the bound on a bf16
    # path's error of those sums (1.5 x the bf16 plain path's largest + 1e-4)
    # of the minimum; and on the images where TP and the unsharded kernels
    # pick the same patch (at least 3 in 4), their masks differ on at most
    # 0.002 of the pixels.
    sums = {name: reference_scores(v[0].float(), (PL_GRID, PL_GRID))[0]
            for name, v in (("f32", ref), ("bf16 plain", bf16_plain), ("TP", tp), ("kernels", kern))}
    tol = 2 * (1.5 * (sums["bf16 plain"] - sums["f32"]).abs().max().item() + 1e-4)
    floor = sums["f32"].min(dim=1).values
    excess = {name: (sums["f32"].gather(1, s.argmin(dim=1, keepdim=True))[:, 0] - floor).max().item()
              for name, s in sums.items()}
    same = (sums["TP"].argmin(dim=1) == sums["kernels"].argmin(dim=1)).cpu().numpy()
    m_tp, m_kern = _pl_masks(*tp), _pl_masks(*kern)
    differ_all = float((m_tp != m_kern).mean())
    differ = float((m_tp[same] != m_kern[same]).mean()) if same.any() else 1.0
    _log(f"  reference patches: the f32 sums' excess of each path's pick over their minimum {excess} (bound "
         f"{tol:.6g}); TP and the unsharded kernels pick the same patch on {int(same.sum())} of {len(same)} images")
    _log(f"  the generator's masks, TP vs unsharded kernels: {differ:.6f} of the pixels differ on those images (bound "
         f"0.002), {differ_all:.6f} on all; vs f32: TP {float((m_tp != _pl_masks(*ref)).mean()):.6f}, unsharded "
         f"kernels {float((m_kern != _pl_masks(*ref)).mean()):.6f}, bf16 plain "
         f"{float((_pl_masks(*bf16_plain) != _pl_masks(*ref)).mean()):.6f}")
    if max(excess.values()) > tol or same.mean() < 0.75 or not differ <= 0.002:
        raise AssertionError(f"TP CLS attention: reference picks {excess} (bound {tol}), {same.mean()} of the images "
                             f"agree, their masks differ on {differ} of the pixels")
    out.update(mask_differ=differ, mask_differ_all=differ_all, same_reference=float(same.mean()))
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


def phase_prototypes(seed: int, dev) -> dict:
    """Phase S: K12 and K13, the TPU fusion prototypes' ports, on their own
    (no product path runs them): launches, agreement with the plain
    versions, and times beside the paths the port runs today, on the timing
    tools' inputs and comparison paths."""
    import torch.nn.functional as F

    from ucod_dpl_tpu_torch.ops.attention import (
        attention_outproj_residual,
        attention_outproj_residual_reference,
        packed_attention,
    )
    from ucod_dpl_tpu_torch.ops.patch_embed import patch_embed, patch_embed_reference, pqc_weight
    from ucod_dpl_tpu_torch.tools import attn_outproj_ab as AO
    from ucod_dpl_tpu_torch.tools import patch_embed_ab as PE
    from ucod_dpl_tpu_torch.tools.attention_ab import _device_ms

    started = time.perf_counter()
    bf16, scale = torch.bfloat16, AO.SCALE
    k12_in = AO._inputs(16, 1370, seed)
    px, kernel, bias, pos = PE._inputs(16, 518, seed)
    w = pqc_weight(kernel).to(bf16).contiguous()
    # the phase's path: K12 once at the serving shape, K13 with and without
    # the position rows at 518px, every count at 0 just before
    attention_outproj_residual.launches = patch_embed.launches = 0
    got12 = attention_outproj_residual(*k12_in, NUM_HEADS, scale, out=_nan_like(k12_in[0]))
    got13 = {p is not None: patch_embed(px, w, bias, p, out=torch.full((16, 37 * 37, SERVE_DIM), float("nan"),
                                                                       device=dev, dtype=bf16))
             for p in (pos, None)}
    torch.cuda.synchronize()
    launches = {"K12": attention_outproj_residual.launches, "K13": patch_embed.launches}
    _log(f"prototypes (phase S): launches {launches}")
    if launches != {"K12": 1, "K13": 2}:
        raise AssertionError(f"phase S launched {launches}, expected K12 once and K13 twice")
    res = {"launches": launches, "err": {}}

    def check12(name, inputs, got):
        ref = attention_outproj_residual_reference(*inputs, NUM_HEADS, scale)
        return _check_residual(f"K12 {name}", got, ref, inputs[3], K12_TOL)

    def check13(name, inputs, got):
        ref = patch_embed_reference(*inputs)
        return _check(f"K13 {name}", got, ref, K13_TOL * ref.float().abs().max().item())

    small = AO._inputs(1, 65, seed + 1)
    res["err"]["K12"] = max(
        check12("bs16 L1370", k12_in, got12),
        check12("B1 L65", small, attention_outproj_residual(*small, NUM_HEADS, scale, out=_nan_like(small[0]))))
    px2, kernel2, bias2, pos2 = PE._inputs(2, 224, seed + 1)
    w2 = pqc_weight(kernel2).to(bf16).contiguous()
    res["err"]["K13"] = max(
        check13("bs16 518px pos", (px, w, bias, pos), got13[True]),
        check13("bs16 518px", (px, w, bias), got13[False]),
        check13("B2 224px pos", (px2, w2, bias2, pos2), patch_embed(px2, w2, bias2, pos2)))
    del got12, got13, small

    # K12 beside its plain version, the composed path of models/dino.py and
    # the cuBLAS out-projection alone
    q, k, v, _, wo = k12_in[:5]

    def k12():
        return attention_outproj_residual(*k12_in, NUM_HEADS, scale)

    def k12_plain():
        return attention_outproj_residual_reference(*k12_in, NUM_HEADS, scale)

    def composed():
        return AO.composed(*k12_in)

    attn = packed_attention(q, k, v, NUM_HEADS, scale)
    ms, plain_ms = _ab_ms(k12_plain, k12, 10)
    ms2, composed_ms = _ab_ms(composed, k12, 20)
    res["K12"] = {"ms": (ms + ms2) / 2, "plain_ms": plain_ms, "composed_ms": composed_ms,
                  "outproj_ms": _time_ms(lambda: F.linear(attn, wo), 20),
                  "device_ms": _device_ms(k12), "composed_device_ms": _device_ms(composed),
                  "composed_max_abs_diff": (k12().float() - composed().float()).abs().max().item()}
    # K13 beside its plain version, _embed's convolution path (and its
    # position add) and one F.conv2d with its bias on the bf16 pixels
    calls = PE.paths(px, kernel, bias, pos)
    px_bf16, kernel_bf16, bias_bf16 = px.to(bf16).permute(0, 3, 1, 2), kernel.to(bf16), bias.to(bf16)
    ms, plain_ms = _ab_ms(calls["plain"], calls["K13"], 20)
    ms2, conv_ms = _ab_ms(calls["conv"], calls["K13"], 20)
    res["K13"] = {"ms": (ms + ms2) / 2, "plain_ms": plain_ms, "conv_path_ms": conv_ms,
                  "library_ms": _time_ms(lambda: F.conv2d(px_bf16, kernel_bf16, bias_bf16, stride=14), 20),
                  "device_ms": _device_ms(calls["K13"]), "conv_path_device_ms": _device_ms(calls["conv"]),
                  "conv_path_max_abs_diff": (calls["K13"]().float() - calls["conv"]().float()).abs().max().item()}
    for kid in ("K12", "K13"):
        _log(f"  {kid} timing: " + ", ".join(f"{key} {val:.4f}" for key, val in res[kid].items()))
    _log(f"prototypes (phase S): {time.perf_counter() - started:.1f} s wall, inputs, checks and timing included")
    return res


def _prototype_entries(proto: dict) -> list:
    """The kernels line's entries of K12 and K13 (phase S).  Bounds at the
    shapes timed: K12 the attention's two products of 2 L^2 64 a head and the
    out-projection's 2 * rows * D^2, against q, k, v, x and out (bf16) and
    wo moved once; K13 2 * rows * 588 * D against the f32 pixels, the bf16
    output, position rows and weight (the f32 vectors left out)."""
    b, l, d, rows = 16, 1370, SERVE_DIM, 16 * 1370
    patches = 16 * 37 * 37
    k12_bound = _bound(2 * 2.0 * b * NUM_HEADS * l * l * (d // NUM_HEADS) + 2.0 * rows * d * d,
                       (5 * rows * d + d * d) * 2, PEAK_BF16)
    k13_bound = _bound(2.0 * patches * 588 * d, 16 * 518 * 518 * 3 * 4 + (patches * d + 37 * 37 * d + 588 * d) * 2,
                       PEAK_BF16)
    micro = "scripts/microbench"
    k12, k13 = proto["K12"], proto["K13"]
    return [
        # launches: phase S's own (no product path runs K12 or K13);
        # composed_ms: K1 + dense + layerscale + residual as models/dino.py
        # runs them, the path K12 would replace (no one PyTorch call
        # computes K12's function)
        {"name": "K12 attention + out-projection + bias + layerscale + residual", "route": "cuda",
         "source": "ucod_dpl_tpu_torch/csrc/attn_outproj.cu", "replaces": f"{micro}/bench_attn_outproj.py:96",
         "launches": proto["launches"]["K12"], "max_abs_err": proto["err"]["K12"], "ms": k12["ms"],
         "plain_ms": k12["plain_ms"], "bound_ms": k12_bound[0], "bound_by": k12_bound[1], "library_ms": None,
         "composed_ms": k12["composed_ms"], "outproj_ms": k12["outproj_ms"], "device_ms": k12["device_ms"],
         "composed_device_ms": k12["composed_device_ms"]},
        # library_ms: one F.conv2d with its bias on the bf16 pixels;
        # conv_path_ms: models/dino.py::_embed's convolution path + position
        {"name": "K13 patch embed as one im2col GEMM + bias + position", "route": "cuda",
         "source": "ucod_dpl_tpu_torch/csrc/patch_embed.cu",
         "replaces": f"{micro}/bench_patch_embed.py:69,105; {micro}/bench_patch_embed3.py:79",
         "launches": proto["launches"]["K13"], "max_abs_err": proto["err"]["K13"], "ms": k13["ms"],
         "plain_ms": k13["plain_ms"], "bound_ms": k13_bound[0], "bound_by": k13_bound[1],
         "library_ms": k13["library_ms"], "conv_path_ms": k13["conv_path_ms"], "device_ms": k13["device_ms"],
         "conv_path_device_ms": k13["conv_path_device_ms"]},
    ]


# Phase T: the K1 variants that port the TPU attention prototypes (their
# shapes: bs16 L1370, and bench_attention_756.py's bs8 L2917 for the row
# variants)
T_SHAPES = {"bs16 L1370": (16, 1370), "bs8 L2917": (8, 2917)}


def phase_attention_variants(seed: int, dev) -> dict:
    """Phase T: the K1 variants of ``tools/attention_ab.py`` that port the
    eight TPU attention prototypes (``SITES``), on no product path: built
    from this checkout in parallel, each launched once at bs16 L1370 (the
    row variants also at bs8 L2917) into a NaN-filled output with its count
    at 0 just before, held against its plain function within K1's bound,
    and timed against K1 by the card's own time (interleaved K1, variant,
    variant, K1), with its plain function and one
    ``scaled_dot_product_attention`` call at the same shape."""
    import torch.nn.functional as F

    from ucod_dpl_tpu_torch.ops.attention import packed_attention
    from ucod_dpl_tpu_torch.tools import attention_ab as AB

    started = time.perf_counter()
    names = list(AB.PROTO_VARIANTS)
    lib = AB.build_variants(names)
    build_s = time.perf_counter() - started
    calls = {name: AB.variant_fn(lib, name) for name in names}
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = {key: tuple(torch.randn(b, l, SERVE_DIM, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
              for key, (b, l) in T_SHAPES.items()}
    runs = {"bs16 L1370": names, "bs8 L2917": list(AB.ROW_VARIANTS)}
    res = {"build_s": build_s, "launches": {}, "err": {}, "ms": {}, "k1_ms": {}, "plain_ms": {}, "sdpa_ms": {}}
    for key, run_names in runs.items():
        q, k, v = inputs[key]
        # the phase's path at this shape: each variant once, every count at 0 just before
        AB.LAUNCHES.clear()
        outs = {name: calls[name](q, k, v, out=_nan_like(q)) for name in run_names}
        torch.cuda.synchronize()
        res["launches"][key] = dict(AB.LAUNCHES)
        if res["launches"][key] != {name: 1 for name in run_names}:
            raise AssertionError(f"phase T at {key} launched {res['launches'][key]}, expected each variant once")
        _log(f"attention variants (phase T) at {key}: launches {res['launches'][key]}")
        for name, out in outs.items():
            ref = AB.plain_of(name)(q, k, v, NUM_HEADS, AB.SCALE)
            res["err"][name, key] = _check(f"{name} {key}", out, ref, K1_TOL * ref.float().abs().max().item())
        del outs, ref
        k1 = functools.partial(packed_attention, q, k, v, NUM_HEADS, AB.SCALE)
        for name in run_names:
            res["k1_ms"][name, key], res["ms"][name, key] = AB._ab_ms(
                k1, functools.partial(calls[name], q, k, v), AB._device_ms)
            res["plain_ms"][name, key] = AB._device_ms(functools.partial(AB.plain_of(name), q, k, v, NUM_HEADS,
                                                                      AB.SCALE), iters=5, warmup=1)
            _log(f"  {name} {key}: {res['ms'][name, key]:.4f} ms against K1's {res['k1_ms'][name, key]:.4f} "
                 f"({res['ms'][name, key] / res['k1_ms'][name, key]:.3f}x), plain {res['plain_ms'][name, key]:.4f}")
        res["sdpa_ms"][key] = AB._device_ms(lambda: F.scaled_dot_product_attention(
            *(_packed_heads(x) for x in (q, k, v)), scale=AB.SCALE))
    res["wall_s"] = time.perf_counter() - started
    _log(f"attention variants (phase T): {res['wall_s']:.1f} s wall, {build_s:.1f} s of it the build")
    _log(json.dumps({"phase_t": {f"{name} {key}": {field: res[field][name, key]
                                                    for field in ("ms", "k1_ms", "plain_ms", "err")}
                                  for name, key in res["ms"]}, "sdpa_ms": res["sdpa_ms"],
                     "wall_s": res["wall_s"], "build_s": build_s}))
    return res


def _variant_entries(t: dict) -> list:
    """The kernels line's entry of each TPU attention prototype site (phase
    T): its first variant's ms, plain ms and error, every variant's beside
    them and K1's, at bs16 L1370 (bench_attention_756.py's at bs8 L2917);
    the bound of K1's function there (two products of 2 L^2 64 a head, q, k,
    v and o moved once) and SDPA's time as the library's."""
    from ucod_dpl_tpu_torch.tools import attention_ab as AB

    entries = []
    for site, (question, variants) in AB.SITES.items():
        key = "bs8 L2917" if site == AB.SITE_756 else "bs16 L1370"
        b, l = T_SHAPES[key]
        bound = _attention_bound(b * NUM_HEADS, l, SERVE_DIM // NUM_HEADS)
        first = variants[0]
        entries.append({
            "name": f"{site.rsplit('/', 1)[1]} ({question}) as K1 variants {', '.join(variants)}, {key}",
            "route": "cuda", "source": "ucod_dpl_tpu_torch/csrc/attention_fwd.cu", "replaces": site,
            # launches: phase T's own (no product path runs a variant)
            "launches": sum(t["launches"][key].get(v, 0) for v in variants),
            "max_abs_err": max(t["err"][v, key] for v in variants), "ms": t["ms"][first, key],
            "plain_ms": t["plain_ms"][first, key], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": t["sdpa_ms"][key], "k1_ms": t["k1_ms"][first, key],
            "variants": {v: {"ms": t["ms"][v, key], "k1_ms": t["k1_ms"][v, key], "plain_ms": t["plain_ms"][v, key],
                             "max_abs_err": t["err"][v, key]} for v in variants},
        })
    return entries


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


def phase_eval(seed: int, dev, smi: str, numpy_scorer: bool = False) -> dict:
    """Phase K: ``cli.eval_main`` on configs/uscod/UCOD-DPL_dinov2.py over a
    32-image synthetic dataset on the card, twice (the first run builds the
    feature cache, the second reads it), with its launch counts, outputs,
    cached-feature accuracy, host-clock rates and a profiler split;
    ``numpy_scorer``: a third sweep from the cache with the NumPy scorer."""
    import shutil

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
    from ucod_dpl_tpu_torch.utils import metrics
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
        metrics.native_scored.update(native=0, numpy=0)
        t0 = time.perf_counter()
        runner = cli.eval_main(argv)["SYN"]
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        scored = dict(metrics.native_scored)
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
        _log("    eval sweep by stage, host clock: " + ", ".join(f"{k} {v:.3f} s" for k, v in ev.split.items())
             + f"; images scored by the native scorer {scored['native']}, by NumPy {scored['numpy']}")
        if scored != {"native": EVAL_IMAGES, "numpy": 0}:
            raise AssertionError(f"eval {run} run: scored {scored}, expected all {EVAL_IMAGES} by the native scorer")
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
                        crops=ev.crops, crop_batches=ev.crop_batches, result=result, split=dict(ev.split),
                        scored=scored)
    if out["second"]["result"] != out["first"]["result"]:
        raise AssertionError(f"eval from the cache: {out['second']['result']} != {out['first']['result']}")
    if numpy_scorer:
        # the same sweep from the cache with the NumPy scorer (UCOD_NATIVE_METRICS=0):
        # its metric seconds beside the native scorer's, and the same metrics
        metrics.native_scored.update(native=0, numpy=0)
        os.environ["UCOD_NATIVE_METRICS"] = "0"
        try:
            ev = cli.eval_main(argv)["SYN"].evaluator
        finally:
            del os.environ["UCOD_NATIVE_METRICS"]
        numpy_diff = max(abs(ev.result[k] - v) for k, v in out["second"]["result"].items())
        out["numpy"] = dict(eval_s=ev.seconds, split=dict(ev.split), scored=dict(metrics.native_scored),
                            diff=numpy_diff)
        _log(f"  from the cache with the NumPy scorer: eval sweep {ev.seconds:.3f} s, metrics "
             f"{ev.split['metrics']:.3f} s (native scorer {out['second']['split']['metrics']:.3f} s), scored "
             f"{out['numpy']['scored']}, metrics within {numpy_diff:.3g} of the native run's [{smi}]")
        if out["numpy"]["scored"] != {"native": 0, "numpy": EVAL_IMAGES} or not numpy_diff <= 1e-9:
            raise AssertionError(f"NumPy scorer run: scored {out['numpy']['scored']}, metrics differ by {numpy_diff}")

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
    out["argv"], out["root"] = argv, root  # phase P2 runs this entry over 2 ranks
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


def _flat_state(state) -> dict:
    """A ``TrainState`` as the JAX package's flat ``{key path: array}`` (the
    ``.npz`` state files' keys: ``decoder/learnable_embedding``, ...)."""
    from ucod_dpl_tpu_torch.engine.checkpoint import flatten_with_paths
    from ucod_dpl_tpu_torch.models.convert import train_state_to_jax

    return flatten_with_paths(train_state_to_jax(state))


def _check_launches(what: str, launches: dict, want: dict) -> None:
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def _train_world(dev, world: dict) -> dict:
    """Phase L's decoder checkpoint over phase M's ``world`` and the argv of
    its train entry: ``{"towers", "argv": argv(run, *flags, **opts),
    "root", "val_paths"}``."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward_resized
    from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint

    root, data = world["root"], world["data"]

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

    return {"towers": towers, "argv": argv, "root": root, "val_paths": val_paths}


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
    from ucod_dpl_tpu_torch.models.discriminator import init_discriminator

    root, train_set = world["root"], world["train_set"]
    _log(f"train entry: {TRAIN_IMAGES} train images ({train_set}), {TRAIN_VAL_IMAGES} val images (TE-CAMO), the "
         f"{PL_GRID}x{PL_GRID} pseudo-label cache generated in phase M")
    tw = _train_world(dev, world)
    towers, argv, val_paths = tw["towers"], tw["argv"], tw["val_paths"]

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
        # phase P1 runs this entry again in a process group of one
        out["final_a"] = _flat_state(loop.state)
        out["argv"], out["root"] = argv, root
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


# Phase O: CORAL stage 2's training on configs/uscod/CORAL_dinov2.py as
# shipped (train set TR-CAMO+TR-COD10K with m-patches at batch 2, window
# size 3, length 56, lr0 1e-4, gamma 0.95 every 2 epochs, EMA from epoch 1 at
# 0.70, a validation every 4 epochs from epoch 4) but for its paths and 8
# epochs cut to 4: 8 of each of phase M's train sets (the same seeded
# images, here with the ground truth the shipped train set requires) with
# their entries of phase M's pseudo-label cache, and 8 val images.
CORAL_TRAIN_PER_SET = 8
CORAL_TRAIN_IMAGES = CORAL_TRAIN_PER_SET * len(TRAIN_SETS)
CORAL_TRAIN_VAL_IMAGES = 8
CORAL_TRAIN_EPOCHS = 4
CORAL_TRAIN_BATCH = 2  # the shipped trainloader_cfg.batch_size


class _CoralTrainProbe:
    """Instruments ``cli.lt_train_main``'s loop: every step by CUDA events
    and host clock with its loss and peak device memory, each epoch by host
    clock (synchronised), a torch.profiler trace of ``profile_epoch``, and,
    with ``preempt_after``, SIGTERM to this process after that step.  The
    originals are restored on exit."""

    def __init__(self, preempt_after=None, profile_epoch=None):
        self.preempt_after, self.profile_epoch = preempt_after, profile_epoch
        self.steps, self.epochs, self.prof = [], [], None
        self.profiling = False

    def __enter__(self):
        from ucod_dpl_tpu_torch.engine import coral_loop, preempt

        loop_cls, probe = coral_loop.LocalRefineTrainLoop, self
        self._orig = (loop_cls.train_step, loop_cls._run_epoch)
        step_fn, epoch_fn = self._orig

        def train_step(loop, *a):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            e0.record()
            loss = step_fn(loop, *a)
            e1.record()
            torch.cuda.synchronize()
            probe.steps.append(dict(loss=loss, events=(e0, e1), host_s=time.perf_counter() - t0,
                                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                                    held_gib=base / 2 ** 30, profiled=probe.profiling))
            if len(probe.steps) == probe.preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
                if preempt.requested() != signal.SIGTERM:
                    raise AssertionError("SIGTERM did not reach the stage-2 loop's handler")
            return loss

        def run_epoch(loop, epoch):
            from torch.profiler import ProfilerActivity, profile

            prof = epoch == probe.profile_epoch
            ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if prof \
                else contextlib.nullcontext()
            n0 = len(probe.steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.profiling = prof
            with ctx as p:
                mean = epoch_fn(loop, epoch)
                torch.cuda.synchronize()
            probe.profiling = False
            probe.epochs.append((epoch, len(probe.steps) - n0, time.perf_counter() - t0))
            if prof:
                probe.prof = (p, probe.epochs[-1][2] * 1e3)
            return mean

        loop_cls.train_step, loop_cls._run_epoch = train_step, run_epoch
        return self

    def __exit__(self, *exc):
        from ucod_dpl_tpu_torch.engine import coral_loop

        coral_loop.LocalRefineTrainLoop.train_step, coral_loop.LocalRefineTrainLoop._run_epoch = self._orig
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
        return False


def phase_coral_train(seed: int, dev, smi: str, world: dict) -> dict:
    """Phase O: ``cli.lt_train_main`` on the card.  Run A (4 epochs): the
    launches of the cache builds (train: features, 3 x 3 grid patches,
    756px m-patches; val: features, grid patches) and the validation's
    centre-crop fallbacks, finite losses, a moving refiner, the epoch and
    EMA files, the epoch-4 validation's metrics, ``cli.lt_eval_main`` on the
    trained file; rates, step ms, peak memory, a trace of one epoch.  Run B:
    SIGTERM after its 10th step, one ``epoch1_preempt`` file, its epoch-1
    file bitwise run A's, and a restart from the preempt file to the end."""
    import filecmp
    import hashlib
    import shutil

    from safetensors.torch import load_file

    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.models.convert import tree_leaves
    from ucod_dpl_tpu_torch.models.udlr import init_sparse_refiner
    from ucod_dpl_tpu_torch.utils.fileio import ArrayCache

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work", "chip_smoke_coral_train")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "RefCOD")
    # the first 8 images of each of phase M's sets (their seeds draw the same
    # images whether or not the ground truth is written), and their entries
    # of phase M's pseudo-label cache (sorted paths over the two sets)
    src = ArrayCache(os.path.join(world["root"], "cache", "pseudo_label_cache", world["train_set"]))
    m_paths = sorted(p for name, _ in TRAIN_SETS for p in glob.glob(os.path.join(world["data"], name, "im", "*.jpg")))
    paths = []
    for i, (name, _) in enumerate(TRAIN_SETS):
        _write_cod_images(data, name, CORAL_TRAIN_PER_SET, seed + 30 + i)
        paths += sorted(glob.glob(os.path.join(data, name, "im", "*.jpg")))
    paths = sorted(paths)
    cache = ArrayCache(os.path.join(root, "cache", "pseudo_label_cache", world["train_set"]))
    for i, p in enumerate(paths):
        twin = os.path.join(world["data"], *p.split(os.sep)[-3:])
        if not filecmp.cmp(p, twin, shallow=False):
            raise AssertionError(f"stage-2 train image {p} differs from phase M's {twin}")
        cache.write(i, src.read(m_paths.index(twin)))
    stems = "\n".join(os.path.splitext(os.path.basename(p))[0] for p in paths)
    cache.flush(meta={"n": len(paths), "fingerprint": hashlib.sha1(stems.encode()).hexdigest(), "th_bkg": 0.6})
    _write_cod_images(data, "TE-CAMO", CORAL_TRAIN_VAL_IMAGES, seed + 60)
    ckpt = os.path.join(world["root"], "decoder.safetensors")  # phase L's seeded towers
    _log(f"CORAL stage-2 training: {CORAL_TRAIN_IMAGES} of phase M's train images ({world['train_set']}) with their "
         f"pseudo-labels, {CORAL_TRAIN_VAL_IMAGES} val images (TE-CAMO), phase L's decoder, a seeded refiner")

    def argv(run, *flags):
        return ["-c", CORAL_CFG, "--load_from", ckpt, "--device", str(dev), "--work_dir",
                os.path.join(root, "work_dir"), *flags, "--opts", "dataset_cfg.dataset_dir", data,
                "dataset_cfg.cache_dir", os.path.join(root, "cache"), "log_cfg.log_path",
                os.path.join(root, f"logs_{run}"), "train_cfg.max_epoch", str(CORAL_TRAIN_EPOCHS)]

    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # run B's epoch-1 file is held to run A's bit for bit
    out = {}
    try:
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with _CoralTrainProbe(profile_epoch=1) as pa:
            run_a = cli.lt_train_main(argv("a"))
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        ev, tr_ds, val_ds = run_a.evaluator, run_a.train_dataset, run_a.val_dataset
        per_chunk = max(1, EVAL_CACHE_BATCH // 9)  # LRDataset's images per grid-patch call
        # train: feature batches, grid-patch and m-patch calls; val: feature
        # batches and grid-patch calls (no m-patches); 2 a centre-crop fallback
        forwards = (-(-CORAL_TRAIN_IMAGES // EVAL_CACHE_BATCH) + 2 * -(-CORAL_TRAIN_IMAGES // per_chunk)
                    + -(-CORAL_TRAIN_VAL_IMAGES // EVAL_CACHE_BATCH) + -(-CORAL_TRAIN_VAL_IMAGES // per_chunk)
                    + 2 * ev.crops)
        want = {**{k: 0 for k in counts}, "K1": 11 * forwards, "K6": 11 * forwards}
        losses = torch.stack([st["loss"] for st in pa.steps]).float().cpu().numpy()
        build_s = tr_ds.build_seconds + tr_ds.patch_build_seconds
        _log(f"  run A ({CORAL_TRAIN_EPOCHS} epochs at batch {CORAL_TRAIN_BATCH}, m-patches): {secs:.3f} s host "
             f"clock in all; train caches {build_s:.3f} s ({CORAL_TRAIN_IMAGES / build_s:.2f} img/s: features "
             f"{tr_ds.build_seconds:.3f} s, grid and m-patches {tr_ds.patch_build_seconds:.3f} s), val caches "
             f"{val_ds.build_seconds + val_ds.patch_build_seconds:.3f} s; {ev.crops} centre-crop fallbacks in the "
             f"validation; launches {launches} [{smi}]")
        _log(f"    losses {np.round(losses, 5).tolist()}; epoch means "
             f"{np.round(run_a.train_loop.epoch_losses, 5).tolist()}")
        _check_launches("lt_train run A", launches, want)
        steps_per_epoch = CORAL_TRAIN_IMAGES // CORAL_TRAIN_BATCH
        if len(losses) != CORAL_TRAIN_EPOCHS * steps_per_epoch or not np.isfinite(losses).all():
            raise AssertionError(f"lt_train run A: {len(losses)} steps, losses {losses}")
        init = tree_leaves(init_sparse_refiner(42 + 2, SERVE_DIM))  # the Runner's seeded refiner (seed + 2)
        if not any(not torch.equal(a, b.cpu()) for a, b in zip(init, tree_leaves(run_a.refiner_params))):
            raise AssertionError("lt_train run A: the refiner did not move")
        ckp = os.path.join(root, "logs_a", "refiner_ckp")
        files = {f: load_file(os.path.join(ckp, f)) for f in sorted(os.listdir(ckp))}
        need = {f"epoch{e}{x}.safetensors" for e in range(1, CORAL_TRAIN_EPOCHS + 1) for x in ("", "_ema")}
        if set(files) != need:
            raise AssertionError(f"lt_train run A: files {sorted(files)}, expected {sorted(need)}")
        for e in range(1, CORAL_TRAIN_EPOCHS + 1):
            raw, ema = files[f"epoch{e}.safetensors"], files[f"epoch{e}_ema.safetensors"]
            same = all(torch.equal(raw[k], ema[k]) for k in raw)
            if same != (e == 1):  # a copy through epoch 0 (start_ema 1), its own from epoch 1 on
                raise AssertionError(f"lt_train run A: epoch {e}'s EMA file equal to the refiner's: {same}")
        result = ev.result
        if set(result) != set(EVAL_KEYS) or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in result.values()):
            raise AssertionError(f"lt_train run A: the epoch-4 validation's result {result}")
        timed = [st for st in pa.steps[1:] if not st["profiled"]]
        ev_ms = [st["events"][0].elapsed_time(st["events"][1]) for st in timed]
        host_ms = [st["host_s"] * 1e3 for st in timed]
        peak = max(st["peak_gib"] for st in pa.steps)
        _log(f"    step ({len(timed)} unprofiled steps after the first): median {np.median(ev_ms):.3f} ms by CUDA "
             f"events (min {min(ev_ms):.3f}, max {max(ev_ms):.3f}), {np.median(host_ms):.3f} ms host clock; peak "
             f"device memory of a step {peak:.3f} GiB ({pa.steps[1]['held_gib']:.3f} GiB held before it) [{smi}]")
        for epoch, n, dt in pa.epochs:
            _log(f"    epoch {epoch}: {n} steps in {dt:.4f} s, {n / dt:.3f} steps/s host clock"
                 + (" (under the profiler)" if epoch == pa.profile_epoch else ""))
        _log(f"    validation at epoch {CORAL_TRAIN_EPOCHS}: {result}")
        from torch.autograd import DeviceType

        prof, wall = pa.prof
        spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
        ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.key not in spans]
        device_ms = sum(e.self_device_time_total for e in ops) / 1e3
        _log(f"    trace of epoch {pa.profile_epoch} ({steps_per_epoch} steps): {device_ms:.3f} ms of device time in "
             f"{wall:.3f} ms of host wall under the profiler, device busy {device_ms / wall:.4f} [{smi}]")
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
            _log(f"      {e.self_device_time_total / 1e3:8.3f} ms {e.self_device_time_total / 1e3 / device_ms:6.3f} "
                 f"x{e.count:5d}  {e.key[:100]}")
        unprof = [(n, dt) for epoch, n, dt in pa.epochs if epoch != pa.profile_epoch]
        out.update(launches=launches, build_img_per_s=CORAL_TRAIN_IMAGES / build_s,
                   steps_per_s=sum(n for n, _ in unprof) / sum(dt for _, dt in unprof), step_ms=float(np.median(ev_ms)),
                   step_host_ms=float(np.median(host_ms)), peak_gib=peak, busy=device_ms / wall, result=result)

        # the trained refiner through the eval entry (the val caches read)
        runner = cli.lt_eval_main([
            "-c", CORAL_CFG, "--load_from", ckpt, "--refiner_path",
            os.path.join(ckp, f"epoch{CORAL_TRAIN_EPOCHS}.safetensors"), "--datasets", "TE-CAMO", "--device", str(dev),
            "--work_dir", os.path.join(root, "work_dir"), "--opts", "dataset_cfg.dataset_dir", data,
            "dataset_cfg.cache_dir", os.path.join(root, "cache"), "log_cfg.log_path",
            os.path.join(root, "logs_eval")])["TE-CAMO"]
        _log(f"  lt_eval on epoch{CORAL_TRAIN_EPOCHS}.safetensors: {runner.evaluator.result}")
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in runner.evaluator.result.values()):
            raise AssertionError(f"lt_eval of the trained refiner: {runner.evaluator.result}")

        # run B: SIGTERM after the 10th step (epoch 1, its 2nd batch)
        with _CoralTrainProbe(preempt_after=10):
            try:
                cli.lt_train_main(argv("b"))
                raise AssertionError("lt_train run B: the entry did not exit on SIGTERM")
            except SystemExit as e:
                code = e.code
        ckp_b = os.path.join(root, "logs_b", "refiner_ckp")
        preempted = sorted(f for f in os.listdir(ckp_b) if f.endswith("_preempt.safetensors"))
        epoch1 = load_file(os.path.join(ckp_b, "epoch1.safetensors"))
        worst = max((epoch1[k] - files["epoch1.safetensors"][k]).abs().max().item() for k in epoch1)
        _log(f"  run B: exit {code} after the 10th step, files {sorted(os.listdir(ckp_b))}; epoch1.safetensors "
             f"differs from run A's by up to {worst:.6g} (bitwise must hold)")
        if code != 128 + signal.SIGTERM or preempted != ["epoch1_preempt.safetensors"] or worst != 0.0:
            raise AssertionError(f"lt_train run B: exit {code}, preempt files {preempted}, epoch-1 difference {worst}")
        restart = cli.lt_train_main(argv("b", "--refiner_path", os.path.join(ckp_b, preempted[0])))
        if len(restart.train_loop.epoch_losses) != CORAL_TRAIN_EPOCHS or \
                not np.isfinite(restart.train_loop.epoch_losses).all():
            raise AssertionError(f"lt_train restart: epoch losses {restart.train_loop.epoch_losses}")
        _log(f"  run B restarted from {preempted[0]}: epoch losses "
             f"{np.round(restart.train_loop.epoch_losses, 5).tolist()}, validation {restart.evaluator.result}")
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    return out


# Phase P: the data-parallel entries (``torch.distributed``), each rank a
# subprocess of this script (``--dp-worker SPEC``): P1 phase L's run A in a
# process group of one (``UCOD_DIST=1 WORLD_SIZE=1``: the NCCL default group
# and the gloo host group start, and, the world being one, no collective
# runs: a plain run), twice; P2 phase K's eval over 2 ranks sharing the one
# card (host collectives over gloo); P3 P1 over 2 ranks on 2 cards where
# there are 2, the only part whose gradient and batch-norm all-reduces run
# over NCCL.
DP_WORKER_TIMEOUT_S = 420


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _trace_summary(prof, wall_ms: float) -> dict:
    """A profiled epoch's device time (annotation spans left out, as in
    ``_TrainProbe.log_trace``), its NCCL kernels and its top operations."""
    from torch.autograd import DeviceType

    spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.key not in spans]
    nccl = [e for e in ops if "nccl" in e.key.lower()]
    return {"device_ms": sum(e.self_device_time_total for e in ops) / 1e3, "wall_ms": wall_ms,
            "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3, "nccl_count": sum(e.count for e in nccl),
            "top": [(e.self_device_time_total / 1e3, e.count, e.key[:100])
                    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]]}


def _collectives_check(dev) -> dict:
    """Each rank of a group of more than one, on its card: the
    discriminator's global batch-norm moments (:func:`_global_moments`, two
    differentiable all-reduces) of this rank's rows of a seeded global
    batch against the local moments of the whole batch, forward and the
    gradient of a weighted sum of the normalised rows back through both
    all-reduces; and the gradient bucket (:func:`all_reduce_mean_`) on the
    decoder's f32 size and an f64 tensor.  The batch is the first conv
    block's output at phase L's shape (local batch ``TRAIN_BATCH``, 32
    channels, 68 x 68).  Returns the largest differences."""
    from ucod_dpl_tpu_torch.models import discriminator
    from ucod_dpl_tpu_torch.parallel import distributed

    rank, world = distributed.process_index(), distributed.process_count()
    gen = torch.Generator().manual_seed(0)
    y = torch.randn(world * TRAIN_BATCH, 32, 68, 68, generator=gen).add_(0.5).to(dev)
    w = torch.randn(y.shape, generator=gen).to(dev)
    rows = slice(rank * TRAIN_BATCH, (rank + 1) * TRAIN_BATCH)

    def normalised_sum(x, moments, wx):
        mean, var, factor = moments(x)
        return (wx * (x - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]).sum(), mean, var, factor

    full = y.clone().requires_grad_(True)
    loss, mean, var, factor = normalised_sum(full, discriminator._local_moments, w)
    loss.backward()
    part = y[rows].clone().requires_grad_(True)
    gloss, gmean, gvar, gfactor = normalised_sum(part, discriminator._global_moments, w[rows])
    gloss.backward()
    want_grad = full.grad[rows]
    gmean, gvar, mean, var = (t.detach() for t in (gmean, gvar, mean, var))
    out = {"mean": float((gmean - mean).abs().max()), "var": float((gvar - var).abs().max()),
           "factor": abs(float(gfactor) - factor),
           "grad_rel": float((part.grad - want_grad).abs().max() / want_grad.abs().max())}
    calls = dict(distributed.grad_all_reduce)
    grads = [torch.full((98_690,), float(rank + 1), device=dev), torch.arange(5, dtype=torch.float64, device=dev)]
    grads[1].mul_(rank)
    distributed.all_reduce_mean_(grads)
    out["bucket"] = max(float((grads[0] - (world + 1) / 2).abs().max()),
                        float((grads[1] - torch.arange(5, dtype=torch.float64, device=dev) * (world - 1) / 2)
                              .abs().max()))
    out["bucket_calls"] = distributed.grad_all_reduce["calls"] - calls["calls"]
    return out


def _dp_worker(spec_path: str) -> int:
    """One rank of phase P: run the entry of ``spec`` with every kernel count
    at 0, write what the run did to ``result{rank}.json`` (and a train run's
    final state to ``state{rank}.npz``) in ``spec["out"]``."""
    from ucod_dpl_tpu_torch import cli
    from ucod_dpl_tpu_torch.parallel import distributed
    from ucod_dpl_tpu_torch.utils import fileio

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = spec["deterministic"]
    rank = int(os.environ.get("RANK", "0"))
    flushes = []
    orig_flush = fileio.ArrayCache.flush

    def flush(cache, *a, **k):  # the cache writes of this rank (index.json is written by flush)
        flushes.append(str(cache.base_path))
        return orig_flush(cache, *a, **k)

    fileio.ArrayCache.flush = flush
    res = {"rank": rank}
    if spec.get("check_collectives"):
        distributed.maybe_initialize_distributed("cuda")
        res["collectives"] = _collectives_check(torch.device("cuda", torch.cuda.current_device()))
    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    for fn in counts.values():
        fn.launches = 0
    distributed.grad_all_reduce.update(calls=0, bytes=0)
    t0 = time.perf_counter()
    if spec["entry"] == "train":
        with _TrainProbe(profile_epoch=spec.get("profile_epoch")) as probe:
            runner = cli.train_main(spec["argv"])
        torch.cuda.synchronize()
        res.update(steps={k: len(v) for k, v in probe.losses.items()}, epochs=probe.epochs,
                   crop_batches=probe.crop_batches(), losses=probe.finite_losses("train").tolist())
        if probe.prof is not None:
            res["trace"] = _trace_summary(*probe.prof)
        np.savez(os.path.join(spec["out"], f"state{rank}.npz"), **_flat_state(runner.train_loop.state))
    else:
        runner = cli.eval_main(spec["argv"])["SYN"]
        ev = runner.evaluator
        res.update(result=ev.result, eval_s=ev.seconds, build_s=runner.val_dataset.build_seconds, crops=ev.crops,
                   crop_batches=ev.crop_batches, images=int(len(runner.val_dataloader._indices())))
    res.update(secs=time.perf_counter() - t0, launches={k: fn.launches for k, fn in counts.items()},
               grad_all_reduce=dict(distributed.grad_all_reduce), world=distributed.process_count(),
               backend=str(torch.distributed.get_backend()) if torch.distributed.is_initialized() else None,
               flushes=flushes, device=torch.cuda.current_device())
    distributed.shutdown()
    with open(os.path.join(spec["out"], f"result{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _rank_env(world: int, port: str) -> list:
    """Each rank's launcher environment for ``world`` ranks on this host."""
    return [{"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port} for r in range(world)]


def _run_ranks(spec: dict, envs: list, worker: str = "--dp-worker") -> list:
    """Start one ``worker`` process (``--dp-worker``, ``--sp-worker``) per
    entry of ``envs`` (each rank's extra environment), wait for all, and
    return their result dicts; a rank that fails or runs past
    ``DP_WORKER_TIMEOUT_S`` fails the phase, and no
    process is left behind."""
    os.makedirs(spec["out"], exist_ok=True)
    spec_path = os.path.join(spec["out"], "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                         "UCOD_DIST")}
    procs, logs = [], []
    try:
        for rank, extra in enumerate(envs):
            log = open(os.path.join(spec["out"], f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), worker, spec_path],
                                          stdout=log, stderr=subprocess.STDOUT, env={**base, **extra},
                                          cwd=os.path.dirname(os.path.abspath(__file__))))
        deadline = time.monotonic() + DP_WORKER_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    out = []
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(spec["out"], f"rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"phase {spec.get('phase', 'P')} {spec['entry']} rank {rank}: exit {p.returncode}\n"
                                 f"{tail}")
        with open(os.path.join(spec["out"], f"result{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _state_close(got: dict, want: dict, what: str) -> float:
    """Two flat train states within rtol 1e-4 / atol 5e-6 (the port's tests'
    hold on a stage-1 state, tests/test_torch_train_loop.py), the learnable
    embeddings by their median and largest drift (their gradient is rounding
    noise that AdamW turns into steps of up to lr); returns the largest
    difference."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(set(got) ^ set(want))[:5]} differ")
    worst = 0.0
    for k in sorted(want):
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        d = np.abs(a - b)
        worst = max(worst, float(d.max()) if d.size else 0.0)
        if k.endswith("learnable_embedding") and "/mu/" not in k and "/nu/" not in k:
            if not (np.median(d) < 5e-5 and d.max() < 2.5e-3):
                raise AssertionError(f"{what}: {k} drifts by median {np.median(d)}, max {d.max()}")
        elif not np.allclose(a, b, rtol=1e-4, atol=5e-6):
            raise AssertionError(f"{what}: {k} differs by up to {d.max()}")
    return worst


def phase_dp(smi: str, evalk: dict, train: dict) -> dict:
    """Phase P: the data-parallel train and eval entries in subprocess ranks
    (P1, P2, and P3 on 2 cards), their launches, all-reduces, outputs
    against phases K and L, and rates."""
    import shutil

    out = {}
    depth = 12  # dinov2-base: K1 and K6 launch 11 times a forward
    want_zero = {k: 0 for k in {**_kernel_wrappers(), **_int8_wrappers()}}
    by_a = train["decoder_steps_per_s"]

    # P1: run A in a group of one, twice, between two runs of the same
    # subprocess without a group (p0, p1, p1b, p0b), the first P1 run with
    # its epoch 1 under the profiler; steps/s over the unprofiled epochs 2
    # and 3 (6 decoder steps) of each.  A group of one is a plain run: no
    # collective, the state bitwise the no-group run's
    runs = {}
    for run in ("p0", "p1", "p1b", "p0b"):
        d = os.path.join(train["root"], f"dp_{run}")
        shutil.rmtree(d, ignore_errors=True)
        env = {} if run.startswith("p0") else {"UCOD_DIST": "1", "WORLD_SIZE": "1"}
        (res,) = _run_ranks({"entry": "train", "argv": train["argv"](run), "out": d, "deterministic": True,
                             "profile_epoch": 1 if run == "p1" else None}, [env])
        with np.load(os.path.join(d, "state0.npz")) as f:
            res["state"] = {k: f[k] for k in f.files}
        res["rate"] = _epoch_rate(res, (2, 3))
        runs[run] = res
    res = runs["p1"]
    ar = res["grad_all_reduce"]
    rate = float(np.median([runs["p1"]["rate"], runs["p1b"]["rate"]]))
    rate0 = float(np.median([runs["p0"]["rate"], runs["p0b"]["rate"]]))
    launches = res["launches"]
    want = {**want_zero, "K1": (depth - 1) * res["crop_batches"], "K6": (depth - 1) * res["crop_batches"]}
    _log(f"phase P1: run A's train entry under UCOD_DIST=1 WORLD_SIZE=1 (world {res['world']}, backend "
         f"{res['backend']}, device cuda:{res['device']}), the caches read: {res['secs']:.3f} s host clock in the "
         f"rank; {res['steps']['train']} decoder and {res['steps']['dis']} discriminator steps; launches {launches} "
         f"({res['crop_batches']} LookTwice crop calls); grad all-reduces {ar} (a world of one launches no "
         f"collective) [{smi}]")
    _log("  decoder steps/s host clock over epochs 2-3, each run a subprocess: "
         + ", ".join(f"{r} {runs[r]['rate']:.3f}" for r in runs)
         + f"; group of one {rate:.3f} against no group {rate0:.3f} (medians); run A in this process "
         f"(epoch 3) {by_a:.3f} [{smi}]")
    trace = res["trace"]
    _log(f"  trace of P1's epoch 1 (3 decoder steps): {trace['device_ms']:.3f} ms of device time in "
         f"{trace['wall_ms']:.3f} ms of host wall under the profiler, device busy "
         f"{trace['device_ms'] / trace['wall_ms']:.4f}; NCCL kernels {trace['nccl_ms']:.4f} ms in "
         f"{trace['nccl_count']} launches [{smi}]")
    for ms, count, name in trace["top"]:
        _log(f"    {ms:8.3f} ms x{count:5d}  {name}")
    _check_launches("P1", launches, want)
    if (res["steps"]["train"], res["steps"]["dis"]) != (12, 6) or res["world"] != 1:
        raise AssertionError(f"P1: {res['steps']} steps in a world of {res['world']}")
    if ar["calls"] or runs["p0"]["grad_all_reduce"]["calls"] or runs["p0"]["world"] != 1:
        raise AssertionError(f"P1: grad all-reduces {ar}, no group {runs['p0']['grad_all_reduce']}: a world of one "
                             "launches none")
    if res["crop_batches"] == 0:
        raise AssertionError("P1: no LookTwice crop call (the kernels of the path did not run)")
    diff_a = _state_close(res["state"], train["final_a"], "P1 against run A")

    def differ(a, b):
        return max(float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max(initial=0))
                   for k in a)

    worst, worst0 = differ(runs["p1b"]["state"], res["state"]), differ(runs["p0"]["state"], res["state"])
    _log(f"  final state against run A's: largest difference {diff_a:.6g} (rtol 1e-4 / atol 5e-6, the learnable "
         f"embeddings by drift); a second P1 run: largest difference {worst:.6g}; the run without a group: "
         f"{worst0:.6g} (both bitwise must hold)")
    if worst != 0.0 or worst0 != 0.0:
        raise AssertionError(f"P1: a second run differs by up to {worst}, the run without a group by {worst0}")
    out.update(p1_launches=launches, p1_rate=rate, p0_rate=rate0, run_a_rate=by_a, p1_diff_a=diff_a,
               p1_busy=trace["device_ms"] / trace["wall_ms"])

    # P2: phase K's eval over 2 ranks on the one card, a fresh cache
    d = os.path.join(evalk["root"], "dp_p2")
    shutil.rmtree(d, ignore_errors=True)
    argv = list(evalk["argv"])
    for key, val in (("dataset_cfg.cache_dir", os.path.join(d, "cache")), ("log_cfg.log_path", os.path.join(d, "logs")),
                     ("--work_dir", os.path.join(d, "work_dir"))):
        argv[argv.index(key) + 1] = val
    port = str(_free_port())
    ranks = _run_ranks({"entry": "eval", "argv": argv, "out": d, "deterministic": False},
                       [{"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                         "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port} for r in range(2)])
    first = evalk["first"]
    cache_batches = -(-EVAL_IMAGES // EVAL_CACHE_BATCH)
    for r in ranks:
        _log(f"phase P2 rank {r['rank']} (cuda:{r['device']}, world {r['world']}, backend {r['backend']}): "
             f"{r['images']} images, cache build "
             + (f"{r['build_s']:.3f} s" if r["build_s"] else "none (waited for rank 0)")
             + f", eval sweep {r['eval_s']:.3f} s, {r['crops']} crops in {r['crop_batches']} calls, K1 "
             f"{r['launches']['K1']} and K6 {r['launches']['K6']} launches, cache flushes {len(r['flushes'])} "
             f"[{smi}]")
    r0, r1 = ranks
    for r in ranks:
        fwd = r["crop_batches"] + (cache_batches if r["rank"] == 0 else 0)
        _check_launches(f"P2 rank {r['rank']}", r["launches"],
                        {**want_zero, "K1": (depth - 1) * fwd, "K6": (depth - 1) * fwd})
    if (len(r0["flushes"]), len(r1["flushes"]), r1["build_s"]) != (1, 0, None) or not r0["build_s"]:
        raise AssertionError(f"P2: cache flushes {r0['flushes']} / {r1['flushes']}, builds {r0['build_s']} / "
                             f"{r1['build_s']}: rank 0 alone must build the cache")
    if (r0["images"], r1["images"]) != (16, 16) or r0["crop_batches"] + r1["crop_batches"] != first["crop_batches"]:
        raise AssertionError(f"P2: images {r0['images']} + {r1['images']}, crop calls {r0['crop_batches']} + "
                             f"{r1['crop_batches']} against phase K's {first['crop_batches']}")
    if r0["result"] != r1["result"]:
        raise AssertionError(f"P2: the ranks' metrics differ: {r0['result']} != {r1['result']}")
    diff_k = max(abs(r0["result"][k] - first["result"][k]) for k in EVAL_KEYS)
    img_s = EVAL_IMAGES / max(r0["eval_s"], r1["eval_s"])
    _log(f"  metrics equal on both ranks, largest difference from phase K's {diff_k:.3g} (1e-12); eval "
         f"{img_s:.2f} img/s over both ranks by the slower sweep's host clock, phase K's one process "
         f"{EVAL_IMAGES / first['eval_s']:.2f} [{smi}]")
    if not diff_k <= 1e-12:
        raise AssertionError(f"P2: metrics {r0['result']} differ from phase K's {first['result']} by {diff_k}")
    out.update(p2_launches={k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}, p2_img_s=img_s,
               p2_diff_k=diff_k)

    # P3: P1 over 2 ranks on 2 cards
    out.update(phase_dp_p3(smi, train))
    return out


def _epoch_rate(res: dict, epochs) -> float:
    """Decoder steps/s by host clock over the train phases of ``epochs``."""
    by = {(k, e): (n, dt) for k, e, n, dt in res["epochs"]}
    return sum(by[("train", e)][0] for e in epochs) / sum(by[("train", e)][1] for e in epochs)


def phase_dp_p3(smi: str, train: dict) -> dict:
    """Phase P3 (with 2 cards; otherwise the script says why it did not
    run): phase L's train entry over 2 ranks, one a card, the NCCL default
    group carrying the gradient buckets and the batch-norm moments.  Before
    the entry each rank checks those collectives (:func:`_collectives_check`,
    the moments within 1e-5, their gradient within 1e-4 of its largest
    value, the bucket exactly); then both ranks' final states bitwise equal
    and finite, one gradient all-reduce an optimizer step of the decoder's
    or the discriminator's f32 bytes, K1 and K6 11 times a forward;
    decoder steps/s and the profiled epoch's NCCL kernels."""
    import shutil

    if torch.cuda.device_count() < 2:
        _log(f"phase P3: not run: {torch.cuda.device_count()} CUDA device visible, it needs 2")
        return {}
    d = os.path.join(train["root"], "dp_p3")
    shutil.rmtree(d, ignore_errors=True)
    port = str(_free_port())
    ranks = _run_ranks({"entry": "train", "argv": train["argv"]("p3"), "out": d, "deterministic": True,
                        "profile_epoch": 1, "check_collectives": True},
                       _rank_env(2, port))
    states = []
    for r in ranks:
        with np.load(os.path.join(d, f"state{r['rank']}.npz")) as f:
            states.append({k: f[k] for k in f.files})
    dec_bytes = 4 * sum(v.size for k, v in states[0].items() if k.startswith("decoder/"))
    dis_bytes = 4 * sum(v.size for k, v in states[0].items() if k.startswith("dis_params/"))
    bad = [k for k in states[0] if not np.array_equal(states[0][k], states[1][k])]
    want_zero = {k: 0 for k in {**_kernel_wrappers(), **_int8_wrappers()}}
    fails = []
    for r in ranks:
        c, ar, steps, trace = r["collectives"], r["grad_all_reduce"], r["steps"], r["trace"]
        forwards = r["crop_batches"] + (-(-TRAIN_IMAGES // EVAL_CACHE_BATCH) - (-TRAIN_VAL_IMAGES // EVAL_CACHE_BATCH)
                                        if r["flushes"] else 0)
        _log(f"phase P3 rank {r['rank']} (cuda:{r['device']}, world {r['world']}, backend {r['backend']}): "
             f"collectives on the card: moments mean {c['mean']:.3g}, var {c['var']:.3g}, factor {c['factor']:.3g}, "
             f"their gradient {c['grad_rel']:.3g} of its largest, bucket {c['bucket']:.3g} in {c['bucket_calls']} "
             f"all-reduces; {steps['train']} decoder and {steps['dis']} discriminator steps, grad all-reduces "
             f"{ar} ({dec_bytes} bytes a decoder step, {dis_bytes} a discriminator step); {r['secs']:.3f} s host "
             f"clock; launches {r['launches']} ({r['crop_batches']} crop calls, cache flushes {len(r['flushes'])}); "
             f"decoder steps/s over epochs 2-3 {_epoch_rate(r, (2, 3)):.3f}; trace of epoch 1: "
             f"{trace['device_ms']:.3f} ms of device time in {trace['wall_ms']:.3f} ms, NCCL kernels "
             f"{trace['nccl_ms']:.4f} ms in {trace['nccl_count']} launches [{smi}]")
        for ms, count, name in trace["top"]:
            _log(f"    {ms:8.3f} ms x{count:5d}  {name}")
        if not (c["mean"] <= 1e-5 and c["var"] <= 1e-5 and c["factor"] <= 1e-6 and c["grad_rel"] <= 1e-4
                and c["bucket"] == 0.0 and c["bucket_calls"] == 2):
            fails.append(f"rank {r['rank']} collectives {c}")
        n = steps["train"] + steps["dis"]
        if r["world"] != 2 or ar["calls"] != n or ar["bytes"] != steps["train"] * dec_bytes + steps["dis"] * dis_bytes:
            fails.append(f"rank {r['rank']}: grad all-reduces {ar} for {steps} in a world of {r['world']}")
        if r["launches"] != {**want_zero, "K1": 11 * forwards, "K6": 11 * forwards} or not r["crop_batches"]:
            fails.append(f"rank {r['rank']}: launches {r['launches']} for {forwards} forwards")
        if trace["nccl_count"] == 0:
            fails.append(f"rank {r['rank']}: no NCCL kernel in the profiled epoch")
    _log(f"  keys that differ between the ranks' final states: {bad[:5]} [{smi}]")
    if bad or not all(np.isfinite(v).all() for v in states[0].values()):
        fails.append(f"the ranks differ in {bad[:5]} or hold non-finite values")
    if fails:
        raise AssertionError("P3: " + "; ".join(fails))
    return {"p3_rate": _epoch_rate(ranks[0], (2, 3)), "p3_nccl_ms": ranks[0]["trace"]["nccl_ms"]}


# Phase Q: sequence parallelism (``parallel/sp.py``): each image's tokens
# padded to a multiple of the ring and split over a ``seq`` mesh axis,
# attention as a ring of K2 calls (one per query chunk and key/value chunk
# with a real key, f32 outputs merged by their log-sum-exps) and, in the
# LoRA step, a ring of K3/K4 calls; on one card named four times (with
# ``--only-q4``, on four cards).  2917 tokens (756px) over 4: chunks of 730,
# the last with 727 real keys; 1370 (518px) over 4: 343, the last 341.
SP_MESHES = (("seq=4", {"data": 1, "seq": 4}), ("model=2 x seq=2", {"data": 1, "model": 2, "seq": 2}))
SP_SHAPES = ((756, 4), (518, 16))  # (image size, batch) of the extraction checks
SP_CHUNKS = (("756px bs4 chunk", 4, 730, (730, 727)), ("518px bs16 chunk", 16, 343, (343, 341)))


def _fe_cfg():
    return _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)


def _sp_pairs(mesh_cfg: dict, seq_len: int) -> int:
    """The ring's K2 (and K3/K4) calls a layer: per model shard, query chunk
    and chunk with a real key."""
    from ucod_dpl_tpu_torch.parallel.sp import chunk_kv_lens

    n = mesh_cfg["seq"]
    return mesh_cfg.get("model", 1) * n * sum(1 for k in chunk_kv_lens(seq_len, n) if k)


def _peaks(devices) -> list:
    """Each distinct card's peak allocated GiB since its last reset."""
    return [torch.cuda.max_memory_allocated(d) / 2**30 for d in sorted(set(devices), key=str)]


def _reset_peaks(devices) -> None:
    for d in set(devices):
        torch.cuda.reset_peak_memory_stats(d)


def phase_sp_kernels(gen, dev) -> dict:
    """Q0: K2 with an f32 output and K3/K4 with f32 outputs at the ring's
    chunk shapes and key bounds, against their plain versions (outputs
    pre-filled with NaN; dK/dV rows past the bound exactly 0); then both
    timed at the 756px chunk, (4, 730, 768), beside SDPA on the same
    tensors."""
    from ucod_dpl_tpu_torch.ops.attention import (
        packed_attention_bwd,
        packed_attention_bwd_reference,
        packed_attention_fwd_lse,
        packed_attention_fwd_lse_reference,
    )

    f32 = torch.float32
    _log("Q0 ring chunk calls vs plain (bf16 in, f32 out, key bound kv_len):")
    worst = {"fwd_lse": 0.0, "bwd": 0.0}
    for name, b, l, kv_lens in SP_CHUNKS:
        q, k, v, do = (_nan_tailed(gen, dev, b, l) for _ in range(4))
        for kv in kv_lens:
            o = torch.full((b, l, SERVE_DIM), float("nan"), device=dev)
            lse = torch.full((b, NUM_HEADS, l), float("nan"), device=dev)
            packed_attention_fwd_lse(q, k, v, NUM_HEADS, 0.125, out=(o, lse), kv_len=kv, out_dtype=f32)
            o_ref, lse_ref = packed_attention_fwd_lse_reference(q, k, v, NUM_HEADS, 0.125, kv_len=kv, out_dtype=f32)
            worst["fwd_lse"] = max(worst["fwd_lse"], _check(f"{name} kv_len {kv} o", o, o_ref,
                                                            K1_TOL * o_ref.abs().max().item()))
            _check(f"{name} kv_len {kv} lse", lse, lse_ref, LSE_TOL)
            o16 = o.to(torch.bfloat16)
            grads = packed_attention_bwd(q, k, v, o16, do, lse, NUM_HEADS, 0.125, kv_len=kv, out_dtype=f32,
                                         out=tuple(torch.full((b, l, SERVE_DIM), float("nan"), device=dev)
                                                   for _ in range(3)))
            refs = packed_attention_bwd_reference(q, k, v, o16, do, lse, NUM_HEADS, 0.125, kv_len=kv, out_dtype=f32)
            for which, got, ref in zip(("dq", "dk", "dv"), grads, refs):
                worst["bwd"] = max(worst["bwd"], _check_grad(f"{name} kv_len {kv} {which}", got, ref))
            if grads[1][:, kv:].any() or grads[2][:, kv:].any():
                raise AssertionError(f"{name} kv_len {kv}: dk/dv rows past the bound are not 0")

    b, l = 4, 730
    q, k, v, do = (torch.randn(b, l, SERVE_DIM, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    out = {"err": worst}
    out["K2"] = _ab_ms(lambda: packed_attention_fwd_lse_reference(q, k, v, NUM_HEADS, 0.125, out_dtype=f32),
                       lambda: packed_attention_fwd_lse(q, k, v, NUM_HEADS, 0.125, out_dtype=f32), 20)
    out["K2_sdpa"] = _sdpa_ms(*(_packed_heads(x) for x in (q, k, v)), 0.125, 20)
    o, lse = packed_attention_fwd_lse(q, k, v, NUM_HEADS, 0.125)
    out["K3"] = _ab_ms(lambda: packed_attention_bwd_reference(q, k, v, o, do, lse, NUM_HEADS, 0.125, out_dtype=f32),
                       lambda: packed_attention_bwd(q, k, v, o, do, lse, NUM_HEADS, 0.125, out_dtype=f32), 20)
    heads = [_packed_heads(x).detach().requires_grad_(True) for x in (q, k, v)]
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(*heads, scale=0.125)
    out["K3_sdpa"] = _time_ms(lambda: torch.autograd.grad(o_sdpa, heads, _packed_heads(do), retain_graph=True), 20)
    bh = b * NUM_HEADS
    # bf16 q/k/v (and o, dO) read once, f32 outputs (and the f32 log-sum-exp) written once
    out["K2_bound"] = _bound(2 * 2.0 * bh * l * l * 64, (3 * 2 + 4) * bh * l * 64 + 4 * bh * l, PEAK_BF16)
    out["K3_bound"] = _bound(5 * 2.0 * bh * l * l * 64, (5 * 2 + 3 * 4) * bh * l * 64 + 4 * bh * l, PEAK_BF16)
    _log(f"  K2 (4, 730, 768) f32 out: kernel {out['K2'][0]:.4f} ms, plain {out['K2'][1]:.4f} ms, "
         f"SDPA {out['K2_sdpa']:.4f} ms, bound {out['K2_bound'][0]:.4f} ms ({out['K2_bound'][1]})")
    _log(f"  K3/K4 (4, 730, 768) f32 out: kernel {out['K3'][0]:.4f} ms, plain {out['K3'][1]:.4f} ms, "
         f"SDPA backward {out['K3_sdpa']:.4f} ms, bound {out['K3_bound'][0]:.4f} ms ({out['K3_bound'][1]})")
    return out


def phase_sp_extract(seed: int, dev, devices) -> dict:
    """Q1: ``FeatureExtractor`` over ``{"data": 1, "seq": 4}`` at 756px bs4
    and 518px bs16 and over ``{"data": 1, "model": 2, "seq": 2}`` at 756px
    bs4 (full-width dinov2-base, seeded random weights, bf16): finite
    features, K2 launched once per model shard, query chunk and key chunk a
    layer (176 and 88 a forward) and nothing else, and err(SP kernels vs f32
    unsharded plain) <= 1.5 * err(bf16 unsharded plain) + 1e-3; then ms per
    extract against the unsharded extractor (K1 + K6), interleaved, and
    each card's peak memory."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.parallel import build_mesh

    counts = {**_kernel_wrappers(), **_int8_wrappers()}
    f32 = FeatureExtractor(_fe_cfg(), device=dev, compute_dtype=torch.float32, seed=seed, strict=False)
    unsharded = FeatureExtractor(_fe_cfg(), device=dev, seed=seed, strict=False)
    fes = {name: FeatureExtractor(_fe_cfg(), mesh=build_mesh(cfg, devices=devices), seed=seed, strict=False)
           for name, cfg in SP_MESHES}
    depth = f32.config.num_layers
    cards = sorted({str(d) for d in devices})
    out = {"launches": {}, "err": {}, "ms": {}, "peak_gib": {}}
    for size, b in SP_SHAPES:
        images = np.random.default_rng(seed + size).standard_normal((b, size, size, 3)).astype(np.float32)
        seq_len = 1 + (size // f32.config.patch_size) ** 2
        ref = _features_plain(f32, images, f32.params, torch.float32)
        err_plain = (_features_plain(unsharded, images, unsharded.params, torch.bfloat16) - ref).abs().max().item()
        bound = 1.5 * err_plain + 1e-3
        meshes = [(name, cfg) for name, cfg in SP_MESHES if size == 756 or "model" not in cfg]
        for name, mesh_cfg in meshes:
            for fn in counts.values():
                fn.launches = 0
            _reset_peaks(devices)
            feats = fes[name].extract(images)
            launches = {k: fn.launches for k, fn in counts.items()}
            peaks = _peaks(devices)
            want = {**{k: 0 for k in counts}, "fwd_lse": (depth - 1) * _sp_pairs(mesh_cfg, seq_len)}
            grid = size // f32.config.patch_size
            if launches != want:
                raise AssertionError(f"SP extract {name} {size}px: launches {launches}, expected {want}")
            if feats.shape != (b, grid, grid, f32.config.hidden_size) or not np.isfinite(feats).all():
                raise AssertionError(f"SP extract {name} {size}px: features {feats.shape}, finite "
                                     f"{np.isfinite(feats).all()}")
            err = (torch.from_numpy(feats).to(dev) - ref).abs().max().item()
            _log(f"Q1 SP extraction {name} ({', '.join(cards)}), {size}px bs{b} (L {seq_len}): launches "
                 f"{ {k: v for k, v in launches.items() if v} }, max_abs_err {err:.6g} vs f32 unsharded plain, "
                 f"bf16 unsharded plain {err_plain:.6g}, bound {bound:.6g}; peak GiB per card "
                 f"{[round(p, 3) for p in peaks]}")
            if not (np.isfinite(err) and err <= bound):
                raise AssertionError(f"SP extract {name} {size}px: error {err} exceeds {bound}")
            out["launches"][f"{name} {size}px"] = launches
            out["err"][f"{name} {size}px"] = err
            out["peak_gib"][f"{name} {size}px"] = peaks
        out["err"][f"bf16 unsharded plain {size}px"] = err_plain
        del ref
        runs = {"unsharded": lambda: unsharded.extract(images),
                **{name: (lambda fe=fes[name]: fe.extract(images)) for name, _ in meshes}}
        _reset_peaks(devices)
        unsharded.extract(images)
        out["peak_gib"][f"unsharded {size}px"] = _peaks([dev])
        samples = {k: [] for k in runs}
        with torch.inference_mode():
            for k in list(runs) + list(runs)[::-1]:
                samples[k].append(_time_ms(runs[k], 3, warmup=1))
        for k, v in samples.items():
            out["ms"][f"{k} {size}px"] = sum(v) / len(v)
            _log(f"  {size}px bs{b} extract {k}: {out['ms'][f'{k} {size}px']:.3f} ms (runs {v[0]:.3f}, {v[1]:.3f}; "
                 f"CUDA events, interleaved, host copies included)")
    _trace(lambda: fes["seq=4"].extract(np.zeros((4, 756, 756, 3), np.float32)), "SP seq=4 extract 756px bs4")
    return out


def phase_sp_lora(seed: int, dev, devices) -> dict:
    """Q2: ``make_lora_train_step(sp_shard=)`` over ``{"seq": 4}`` at 756px
    bs4 (full-width dinov2-base, remat none, bf16): three steps with finite
    losses and moving adapters, each launching K2 and K3/K4 176 times and
    nothing else; the third step's decoder + LoRA gradients against the
    unsharded kernel step's on the same state (norm-relative <= 0.1, phase
    B's bound, also the LoRA gradients alone); a second run of the three
    steps equal bit for bit; step ms by CUDA events and each card's peak
    memory against the unsharded step."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step
    from ucod_dpl_tpu_torch.models.convert import tree_leaves
    from ucod_dpl_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"seq": 4}, devices=devices)
    counts = _kernel_wrappers()
    out = {}

    def run(check: bool):
        cfg, fe, state, lora, lora_opt, pixels, labels = _lora_setup(seed + 20, dev, 4, size=756)
        step = make_lora_train_step(cfg, fe.config, torch.bfloat16, sp_shard=(mesh, "seq"))
        pairs = (fe.config.num_layers - 1) * _sp_pairs({"seq": 4}, 1 + (756 // fe.config.patch_size) ** 2)
        for i in range(3):
            if i == 2 and check:
                g_sp = _grads(step.loss_fn, state, lora, fe, pixels, labels)
                plain_step = make_lora_train_step(cfg, fe.config, torch.bfloat16)
                g_un = _grads(plain_step.loss_fn, state, lora, fe, pixels, labels)
                for name, gs, gu in (("decoder + LoRA", torch.cat(g_sp), torch.cat(g_un)),
                                     ("LoRA alone", g_sp[1], g_un[1])):
                    rel = ((gs - gu).norm() / gu.norm()).item()
                    out[f"grad_rel {name}"] = rel
                    _log(f"  step 3 grads, SP vs unsharded kernels, {name}: norm-relative difference {rel:.6g} "
                         f"(bound 0.1), largest difference {(gs - gu).abs().max().item():.6g}")
                    if not (np.isfinite(rel) and rel <= 0.1):
                        raise AssertionError(f"SP LoRA grads ({name}): {rel} exceeds 0.1")
                del g_sp, g_un
            for fn in counts.values():
                fn.launches = 0
            aux = step(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)
            loss = aux["loss"].item()
            launches = {k: fn.launches for k, fn in counts.items()}
            b_norm = torch.sqrt(sum(e["b"].float().square().sum() for layer in lora for e in layer.values())).item()
            if check:
                _log(f"  step {i + 1}: loss {loss:.6f}, adapter B-norm {b_norm:.6g}, launches {launches}")
            want = {"K1": 0, "K5": 0, "K6": 0, "K7": 0, "fwd_lse": pairs, "bwd": pairs}
            if launches != want or not np.isfinite(loss) or not b_norm > 0:
                raise AssertionError(f"SP LoRA step {i + 1}: loss {loss}, B-norm {b_norm}, launches {launches}, "
                                     f"expected {want}")
            out["launches"] = launches
        return cfg, fe, state, lora, lora_opt, pixels, labels, step

    _log(f"Q2 LoRA step under SP {{'seq': 4}} ({', '.join(sorted({str(d) for d in devices}))}), dinov2-base "
         f"756px bs4 bf16, remat none:")
    first = run(check=True)
    second = run(check=False)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(first[3]) + tree_leaves(first[2].decoder),
                                                   tree_leaves(second[3]) + tree_leaves(second[2].decoder)))
    _log(f"  two runs of three steps bitwise equal (adapters and decoder): {same}")
    if not same:
        raise AssertionError("SP LoRA: two runs differ")
    del second
    cfg, fe, state, lora, lora_opt, pixels, labels, sp_step = first
    un_step = make_lora_train_step(cfg, fe.config, torch.bfloat16)

    def call(step):
        return lambda: step(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)

    for name, step in (("SP", sp_step), ("unsharded", un_step)):
        torch.cuda.synchronize()
        _reset_peaks(devices)
        call(step)()
        torch.cuda.synchronize()
        out[f"peak_gib {name}"] = _peaks(devices if name == "SP" else [dev])
    out["ms"] = _ab_ms(call(un_step), call(sp_step), 3)
    _log(f"  step 756px bs4: SP {out['ms'][0]:.3f} ms, unsharded {out['ms'][1]:.3f} ms (CUDA events, "
         f"interleaved); peak GiB per card SP {[round(p, 3) for p in out['peak_gib SP']]}, unsharded "
         f"{[round(p, 3) for p in out['peak_gib unsharded']]}")
    _trace(call(sp_step), "SP LoRA step 756px bs4", inference=False)
    return out


def phase_remat_dots(seed: int, dev) -> dict:
    """Q3: the LoRA step at bs16 518px, unsharded, with remat "dots" (the
    outputs of the projections saved, the rest recomputed): at the third
    step its decoder + LoRA gradients against remat "none"'s on the same
    state (phase B's bound, 0.1; the largest difference printed), 22
    forward-LSE launches (the attention forward recomputed) and 11 backward
    a step; ms and peak memory of none, layer and dots, interleaved."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step

    cfg, fe, state, lora, lora_opt, pixels, labels = _lora_setup(seed + 30, dev, 16)
    steps = {mode: make_lora_train_step(_train_cfg(mode), fe.config, torch.bfloat16)
             for mode in ("none", "layer", "dots")}
    for _ in range(2):
        steps["none"](state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)
    g_none = torch.cat(_grads(steps["none"].loss_fn, state, lora, fe, pixels, labels))
    g_dots = torch.cat(_grads(steps["dots"].loss_fn, state, lora, fe, pixels, labels))
    rel = ((g_dots - g_none).norm() / g_none.norm()).item()
    largest = (g_dots - g_none).abs().max().item()
    _log(f"Q3 remat dots, LoRA step 3 bs16 518px bf16: grads vs none norm-relative {rel:.6g} (bound 0.1), largest "
         f"difference {largest:.6g} (max |g| {g_none.abs().max().item():.6g})")
    if not (np.isfinite(rel) and rel <= 0.1):
        raise AssertionError(f"remat dots grads: {rel} exceeds 0.1")
    del g_none, g_dots
    out = {"grad_rel": rel, "grad_max_diff": largest, "ms": {}, "peak_gib": {}, "launches": {}}
    counts = _kernel_wrappers()

    def call(mode):
        return lambda: steps[mode](state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)

    for mode in steps:
        for fn in counts.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call(mode)()
        torch.cuda.synchronize()
        out["peak_gib"][mode] = torch.cuda.max_memory_allocated() / 2**30
        out["launches"][mode] = {k: fn.launches for k, fn in counts.items() if fn.launches}
    depth = fe.config.num_layers
    want = {"fwd_lse": 2 * (depth - 1), "bwd": depth - 1}  # the attention forward runs again in the backward
    if out["launches"]["dots"] != want:
        raise AssertionError(f"remat dots: launches {out['launches']['dots']}, expected {want}")
    samples = {mode: [] for mode in steps}
    for mode in list(steps) + list(steps)[::-1]:
        samples[mode].append(_time_ms(call(mode), 3, warmup=1))
    for mode, v in samples.items():
        out["ms"][mode] = sum(v) / len(v)
        _log(f"  remat {mode}: {out['ms'][mode]:.3f} ms (runs {v[0]:.3f}, {v[1]:.3f}), peak "
             f"{out['peak_gib'][mode]:.3f} GiB, launches {out['launches'][mode]}")
    return out


def phase_tp_cards(seed: int, devices) -> dict:
    """``--only-q4``: phase I's ``{"model": 4}`` extract at bs16 518px over
    four cards against the same mesh on one card named four times and the
    unsharded extract, interleaved, with each card's peak memory."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.parallel import build_mesh

    dev = devices[0]
    fes = {"unsharded": FeatureExtractor(_fe_cfg(), device=dev, seed=seed, strict=False),
           "model=4, one card": FeatureExtractor(_fe_cfg(), mesh=build_mesh({"data": 1, "model": 4},
                                                                           devices=[dev] * 4), seed=seed, strict=False),
           "model=4, four cards": FeatureExtractor(_fe_cfg(), mesh=build_mesh({"data": 1, "model": 4},
                                                                             devices=devices), seed=seed, strict=False)}
    images = np.random.default_rng(seed + 9).standard_normal((16, 518, 518, 3)).astype(np.float32)
    feats = {k: fe.extract(images) for k, fe in fes.items()}
    diff = float(np.abs(feats["model=4, four cards"] - feats["model=4, one card"]).max())
    out = {"max_abs_diff four vs one card": diff, "ms": {}, "peak_gib": {}}
    for k, fe in fes.items():
        _reset_peaks(devices)
        fe.extract(images)
        out["peak_gib"][k] = _peaks(devices)
    samples = {k: [] for k in fes}
    with torch.inference_mode():
        for k in list(fes) + list(fes)[::-1]:
            samples[k].append(_time_ms(lambda fe=fes[k]: fe.extract(images), 3, warmup=1))
    _log(f"TP model=4 over {len(set(devices))} cards, bs16 518px bf16: features differ from one card's by "
         f"{diff:.6g}")
    for k, v in samples.items():
        out["ms"][k] = sum(v) / len(v)
        _log(f"  {k}: {out['ms'][k]:.3f} ms (runs {v[0]:.3f}, {v[1]:.3f}), peak GiB per card "
             f"{[round(p, 3) for p in out['peak_gib'][k]]}")
    if not (np.isfinite(diff) and diff <= 1e-3):
        raise AssertionError(f"TP over four cards differs from one card's by {diff}")
    return out


# Phase R (``--only-r4``, four cards): sequence parallelism across
# processes, one process per card (R1, R2) or per two cards (R3), the ring
# between processes over NCCL send/recv (``parallel/distributed.py::
# ring_exchange``) and inside a process by device copies.  Each rank is this
# script run as ``--sp-worker SPEC``.
SP_RANK_SEQ_LEN = 1 + (756 // 14) ** 2  # 2917 tokens at 756px, chunks of 730 over 4


def _world_gather(t: torch.Tensor) -> list:
    """``t`` of every rank, in rank order, over NCCL (the default group)."""
    parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, t.contiguous())
    return parts


def _r1_ring(spec: dict, dev) -> dict:
    """R1 in one rank: the ring over ``{"seq": 4}`` across the processes at
    the 756px bs4 chunk (4, 730, 768) bf16, forward and backward (the
    incoming gradient a seeded tensor), then every rank's output and
    gradient chunks gathered on rank 0 and held bit for bit against the
    one-process ring on rank 0's card (named four times) over the same
    inputs.  Times: the process ring's forward + backward by CUDA events
    (all ranks in step), and on rank 0 alone the one-process ring on one
    card and on the four cards."""
    from ucod_dpl_tpu_torch.parallel import build_mesh, distributed
    from ucod_dpl_tpu_torch.parallel import sp as SP

    mesh = build_mesh({"seq": 4})
    rank = distributed.process_index()
    (i,) = mesh.local_block()["seq"]
    kv_lens = SP.chunk_kv_lens(SP_RANK_SEQ_LEN, 4)
    gen = torch.Generator().manual_seed(spec["seed"])
    full = [torch.randn(4, SP_RANK_SEQ_LEN, SERVE_DIM, generator=gen).to(dev, torch.bfloat16) for _ in range(4)]
    scale = 1.0 / 8.0
    counts = _kernel_wrappers()

    def chunks(devices, positions):
        """The q/k/v and incoming-gradient chunks at ``positions`` (all when
        None) on ``devices``."""
        return [SP.split_tokens(x, devices, n=4, positions=positions) for x in full]

    def ring(parts, m):
        leaves = [[c.detach().requires_grad_(True) for c in cs] for cs in parts[:3]]
        outs = SP.ring_attention(*leaves, NUM_HEADS, scale=scale, kv_lens=kv_lens, mesh=m)
        torch.autograd.backward(outs, parts[3])
        return outs, leaves

    mine = chunks([dev], [i])
    for fn in counts.values():
        fn.launches = 0
    outs, leaves = ring(mine, mesh)
    launches = {k: fn.launches for k, fn in counts.items() if fn.launches}
    gathered = [_world_gather(t) for t in [outs[0].detach()] + [t[0].grad for t in leaves]]
    distributed.ring_traffic.update(calls=0, bytes=0)
    ring(mine, mesh)
    traffic = dict(distributed.ring_traffic)
    ms = _time_ms(lambda: ring(mine, mesh), 5, warmup=2)
    out = {"launches": launches, "ms": ms, "traffic": traffic}
    distributed.barrier("R1 one-process ring")
    if rank == 0:
        one, on_one = build_mesh({"seq": 4}, devices=[dev] * 4), chunks([dev] * 4, None)
        outs, leaves = ring(on_one, one)
        ref = [[o.detach() for o in outs]] + [[t.grad for t in ts] for ts in leaves]
        out["equal"] = {name: all(torch.equal(g.to(dev), r) for g, r in zip(got, want))
                        for name, got, want in zip(("out", "dq", "dk", "dv"), gathered, ref)}
        out["one_card_ms"] = _time_ms(lambda: ring(on_one, one), 5, warmup=2)
        cards = [torch.device("cuda", c) for c in range(4)]
        four, on_four = build_mesh({"seq": 4}, devices=cards), chunks(cards, None)
        out["four_cards_ms"] = _time_ms(lambda: ring(on_four, four), 5, warmup=2)
    distributed.barrier("R1 end")
    return out


def _r_lora(spec: dict, dev) -> dict:
    """R2 or R3 in one rank: ``make_lora_train_step(sp_shard=)`` on the mesh
    over processes of ``spec["mesh"]`` at 756px, the global batch of
    ``spec["batch"]`` on every rank, full-width dinov2-base bf16, remat
    none.  Three steps: finite losses, moving adapters, each step's
    launches; rank 0 writes the state the third step starts from and that
    step's reduced gradients (left in ``.grad``) for the unsharded step's
    gradients in the parent process.  After the steps every rank's state
    is gathered and compared with rank 0's bit for bit.
    Then the step's ms by CUDA events and host wall (all ranks in step),
    a trace of one step (busy share, NCCL kernels) and each local card's
    peak memory over one step."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step
    from ucod_dpl_tpu_torch.models.convert import tree_leaves, tree_map
    from ucod_dpl_tpu_torch.parallel import build_mesh, distributed

    mesh = build_mesh(spec["mesh"])
    rank = distributed.process_index()
    cards = sorted({mesh.device(**dict(zip(mesh.axis_names, c))) for c in
                    np.argwhere(mesh.ranks == rank).tolist()}, key=str)
    cfg, fe, state, lora, lora_opt, pixels, labels = _lora_setup(spec["seed"], dev, spec["batch"], size=756)
    step = make_lora_train_step(cfg, fe.config, torch.bfloat16, sp_shard=(mesh, "seq"))
    counts = _kernel_wrappers()
    out = {"cards": [str(c) for c in cards], "steps": []}

    def call():
        return step(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)

    for i in range(3):
        if i == 2 and rank == 0:
            torch.save({k: tree_map(lambda t: t.detach().cpu(), v) for k, v in (
                ("decoder", state.decoder), ("decoder_ema", state.decoder_ema), ("dis_params", state.dis_params),
                ("dis_stats", state.dis_stats), ("lora", lora))}, os.path.join(spec["out"], "before_step3.pt"))
        for fn in counts.values():
            fn.launches = 0
        aux = call()
        loss = aux["loss"].item()
        b_norm = torch.sqrt(sum(e["b"].float().square().sum() for layer in lora for e in layer.values())).item()
        out["steps"].append({"loss": loss, "lora_grad_norm": aux["lora_grad_norm"].item(), "b_norm": b_norm,
                             "launches": {k: fn.launches for k, fn in counts.items()}})
        if i == 2 and rank == 0:
            torch.save([torch.cat([t.grad.float().flatten() for t in tree_leaves(tree)]).cpu()
                        for tree in (state.decoder, lora)], os.path.join(spec["out"], "grads_step3.pt"))
    flat = torch.cat([t.detach().float().flatten() for t in tree_leaves(state.decoder) + tree_leaves(state.decoder_ema)
                      + tree_leaves(lora)])
    out["bitwise_equal_ranks"] = all(torch.equal(f, flat) for f in _world_gather(flat))
    out["finite_state"] = bool(torch.isfinite(flat).all())

    distributed.ring_traffic.update(calls=0, bytes=0)
    distributed.grad_all_reduce.update(calls=0, bytes=0)
    call()
    out["ring_traffic"], out["grad_all_reduce"] = dict(distributed.ring_traffic), dict(distributed.grad_all_reduce)
    out["ms"] = _time_ms(call, 3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    out["host_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    call()
    torch.cuda.synchronize()
    out["peak_gib"] = [torch.cuda.max_memory_allocated(c) / 2**30 for c in cards]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["trace"] = _trace_summary(prof, wall)
    distributed.barrier("R end")
    return out


def _sp_worker(spec_path: str) -> int:
    """One rank of phase R: join the NCCL group with ``spec["cards"]`` cards,
    run ``spec["entry"]`` (``ring``: R1, ``lora``: R2/R3) and write
    ``result{rank}.json`` to ``spec["out"]``."""
    from ucod_dpl_tpu_torch.parallel import distributed

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed.maybe_initialize_distributed("cuda", cards=spec["cards"])
    rank = distributed.process_index()
    t0 = time.perf_counter()
    res = {"rank": rank, "device": str(dev), "world": distributed.process_count(),
           "backend": str(torch.distributed.get_backend())}
    res.update(_r1_ring(spec, dev) if spec["entry"] == "ring" else _r_lora(spec, dev))
    res["secs"] = time.perf_counter() - t0
    distributed.shutdown()
    with open(os.path.join(spec["out"], f"result{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


# phase R's bounds on the norm-relative gradient difference from the
# unsharded step: about 10x what the H100 gave (decoder + LoRA 2.86e-4 and
# 1.98e-4, LoRA alone 1.66e-3 and 1.62e-3 in R2 and R3), under phase B's
# 0.1, so a fault outside the ring (a wrong data or seq reduction) shows
R_GRAD_BOUND = {"decoder + LoRA": 3e-3, "LoRA alone": 2e-2}


def phase_sp_processes(seed: int, smi: str) -> dict:
    """Phase R on four cards: R1 the ring alone over 4 processes (bitwise the
    one-process ring, 4 K2 and 4 K3/K4 launches a rank), R2 the SP LoRA
    step over ``{"seq": 4}`` on 4 processes at 756px bs4 (44 K2 and 44
    K3/K4 a rank a step and nothing else of K1/K5/K6/K7, ranks bitwise
    equal, gradients within ``R_GRAD_BOUND`` of the unsharded step's), R3
    over ``{"data": 2, "seq": 2}`` on 2 processes of 2 cards at 756px bs8
    (the JAX oracle's layout: the ring inside each process, the data axis
    across).  Then, in
    this process, the unsharded step at bs4 and bs8 and the one-process SP
    step over the four cards (one process driving every card) at bs4,
    interleaved with the unsharded bs4 step, and their peak memory."""
    import shutil

    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step
    from ucod_dpl_tpu_torch.parallel import build_mesh

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work", "chip_smoke_sp")
    shutil.rmtree(root, ignore_errors=True)
    out, fails = {}, []

    d = os.path.join(root, "r1")
    r1 = _run_ranks({"phase": "R1", "entry": "ring", "out": d, "cards": 1, "seed": seed},
                    _rank_env(4, str(_free_port())), worker="--sp-worker")
    for r in r1:
        _log(f"R1 rank {r['rank']} ({r['device']}, {r['backend']}): the ring at 756px bs4 over 4 processes, "
             f"launches {r['launches']}, forward + backward {r['ms']:.3f} ms (CUDA events), sent "
             f"{r['traffic']['bytes'] / 1e6:.2f} MB in {r['traffic']['calls']} exchanges a call [{smi}]")
        if r["launches"] != {"fwd_lse": 4, "bwd": 4}:
            fails.append(f"R1 rank {r['rank']}: launches {r['launches']}")
    r0 = r1[0]
    _log(f"  one-process ring on one card {r0['one_card_ms']:.3f} ms, on four cards {r0['four_cards_ms']:.3f} ms; "
         f"the process ring bitwise equal to the one-process ring: {r0['equal']}")
    if not all(r0["equal"].values()):
        fails.append(f"R1: the process ring differs from the one-process ring: {r0['equal']}")
    out["r1"] = {"ms": r0["ms"], "one_card_ms": r0["one_card_ms"], "four_cards_ms": r0["four_cards_ms"],
                 "equal": r0["equal"], "launches": r0["launches"]}

    depth_pairs = 11 * 4  # 11 attention layers x (one query chunk x 4 key chunks, or 2 x 2)
    for name, mesh_cfg, world, cards, batch in (("R2", {"seq": 4}, 4, 1, 4), ("R3", {"data": 2, "seq": 2}, 2, 2, 8)):
        d = os.path.join(root, name.lower())
        ranks = _run_ranks({"phase": name, "entry": "lora", "out": d, "cards": cards, "seed": seed + 20,
                            "mesh": mesh_cfg, "batch": batch}, _rank_env(world, str(_free_port())), worker="--sp-worker")
        want = {"K1": 0, "K5": 0, "K6": 0, "K7": 0, "fwd_lse": depth_pairs, "bwd": depth_pairs}
        for r in ranks:
            for i, st in enumerate(r["steps"]):
                _log(f"{name} rank {r['rank']} ({', '.join(r['cards'])}) step {i + 1}: loss {st['loss']:.6f}, lora grad "
                     f"norm {st['lora_grad_norm']:.6g}, adapter B-norm {st['b_norm']:.6g}, launches {st['launches']}")
                if st["launches"] != want or not np.isfinite(st["loss"]) or not st["b_norm"] > 0:
                    fails.append(f"{name} rank {r['rank']} step {i + 1}: {st}, expected launches {want}")
            tr = r["trace"]
            _log(f"  {name} rank {r['rank']}: step {r['ms']:.3f} ms (CUDA events), {r['host_ms']:.3f} ms host wall; "
                 f"peak GiB {[round(p, 3) for p in r['peak_gib']]}; ring {r['ring_traffic']['bytes'] / 1e6:.2f} MB in "
                 f"{r['ring_traffic']['calls']} exchanges, gradient all-reduces {r['grad_all_reduce']} a step; "
                 f"trace: {tr['device_ms']:.3f} ms of device time in {tr['wall_ms']:.3f} ms (busy "
                 f"{tr['device_ms'] / tr['wall_ms']:.4f}), NCCL kernels {tr['nccl_ms']:.3f} ms in {tr['nccl_count']} "
                 f"launches; ranks bitwise equal {r['bitwise_equal_ranks']} [{smi}]")
            for ms, count, kname in tr["top"]:
                _log(f"      {ms:8.3f} ms x{count:5d}  {kname}")
            if not (r["bitwise_equal_ranks"] and r["finite_state"]):
                fails.append(f"{name} rank {r['rank']}: states equal {r['bitwise_equal_ranks']}, finite "
                             f"{r['finite_state']}")
        r0 = ranks[0]
        out[name.lower()] = {"ms": [r["ms"] for r in ranks], "host_ms": [r["host_ms"] for r in ranks],
                             "busy": [r["trace"]["device_ms"] / r["trace"]["wall_ms"] for r in ranks],
                             "nccl_ms": [r["trace"]["nccl_ms"] for r in ranks],
                             "nccl_count": [r["trace"]["nccl_count"] for r in ranks],
                             "peak_gib": [r["peak_gib"] for r in ranks], "launches": r0["steps"][-1]["launches"],
                             "ring_bytes": r0["ring_traffic"]["bytes"]}
    if fails:
        raise AssertionError("phase R: " + "; ".join(fails))

    # the references in this process, the ranks gone: the unsharded step's
    # gradients from the state each run's third step started from, against
    # that step's; the unsharded step at both batches and the one-process SP
    # step over the four cards at bs4
    from ucod_dpl_tpu_torch.models.convert import tree_map

    devices = [torch.device("cuda", c) for c in range(4)]
    dev = devices[0]
    for name, batch in (("R2", 4), ("R3", 8)):
        cfg, fe, state, lora, lora_opt, pixels, labels = _lora_setup(seed + 20, dev, batch, size=756)
        un = make_lora_train_step(cfg, fe.config, torch.bfloat16)
        d = os.path.join(root, name.lower())
        saved = torch.load(os.path.join(d, "before_step3.pt"), weights_only=False)  # the decoder's NamedTuple
        grad_state = dataclasses.replace(state, **{
            k: tree_map(lambda t: t.to(dev).requires_grad_(k == "decoder"), saved[k])
            for k in ("decoder", "decoder_ema", "dis_params", "dis_stats")})
        grad_lora = tree_map(lambda t: t.to(dev).requires_grad_(True), saved["lora"])
        g_un = _grads(un.loss_fn, grad_state, grad_lora, fe, pixels, labels, epoch=0.0)
        g_sp = [g.to(dev) for g in torch.load(os.path.join(d, "grads_step3.pt"))]
        for g, a, b in (("decoder + LoRA", torch.cat(g_sp), torch.cat(g_un)), ("LoRA alone", g_sp[1], g_un[1])):
            rel = ((a - b).norm() / b.norm()).item()
            out[name.lower()][f"grad_rel {g}"] = rel
            _log(f"  {name} step 3 grads vs the unsharded kernel step on the global batch from the same state, {g}: "
                 f"norm-relative {rel:.6g} (bound {R_GRAD_BOUND[g]:g}; phase B's 0.1), largest difference "
                 f"{(a - b).abs().max().item():.6g}")
            if not (np.isfinite(rel) and rel <= R_GRAD_BOUND[g]):
                raise AssertionError(f"{name} grads ({g}): {rel} exceeds {R_GRAD_BOUND[g]:g}")
        del saved, grad_state, grad_lora, g_un, g_sp
        steps = {"unsharded": un}
        if batch == 4:
            steps["one process, four cards"] = make_lora_train_step(
                cfg, fe.config, torch.bfloat16, sp_shard=(build_mesh({"seq": 4}, devices=devices), "seq"))
        ref = {}
        for k, st in steps.items():
            torch.cuda.synchronize()
            _reset_peaks(devices)
            st(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0)
            torch.cuda.synchronize()
            ref[f"peak_gib {k}"] = _peaks(devices if k != "unsharded" else [dev])
        calls = {k: (lambda st=st: st(state, lora, lora_opt, fe.params, pixels, labels, 0.0, 1.0))
                 for k, st in steps.items()}
        if batch == 4:
            ref["ms"] = dict(zip(("one process, four cards", "unsharded"),
                                 _ab_ms(calls["unsharded"], calls["one process, four cards"], 3)))
        else:
            ref["ms"] = {"unsharded": _time_ms(calls["unsharded"], 3, warmup=1)}
        _log(f"reference steps at 756px bs{batch} in one process: "
             + ", ".join(f"{k} {v:.3f} ms (peak GiB {[round(p, 3) for p in ref[f'peak_gib {k}']]})"
                         for k, v in ref["ms"].items()) + f" [{smi}]")
        out[f"reference_bs{batch}"] = ref
        del cfg, fe, state, lora, lora_opt, pixels, labels, steps, calls
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights and inputs")
    parser.add_argument("--dp-worker", metavar="SPEC", help=argparse.SUPPRESS)  # one rank of phase P
    parser.add_argument("--only-p3", action="store_true",
                        help="run phase P3 alone (2 cards), after the data and checkpoint it needs")
    parser.add_argument("--only-q4", action="store_true",
                        help="run phases Q1 and Q2 over four cards and phase I's model=4 over four cards alone")
    parser.add_argument("--sp-worker", metavar="SPEC", help=argparse.SUPPRESS)  # one rank of phase R
    parser.add_argument("--only-r4", action="store_true",
                        help="run phase R (sequence parallelism across processes) on four cards alone")
    parser.add_argument("--numpy-scorer", action="store_true",
                        help="phase K also sweeps the cache with the NumPy scorer, for its metric seconds")
    args = parser.parse_args(argv)
    if args.dp_worker:
        return _dp_worker(args.dp_worker)
    if args.sp_worker:
        return _sp_worker(args.sp_worker)
    if args.only_r4:
        smi = phase_device()
        if torch.cuda.device_count() < 4:
            print(f"chip_smoke: --only-r4 needs 4 CUDA devices, {torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        phase_build()
        r = phase_sp_processes(args.seed, smi)
        _log(json.dumps({"card": smi, "sp_process_ring_ms": r["r1"]["ms"],
                         "sp_one_process_ring_one_card_ms": r["r1"]["one_card_ms"],
                         "sp_one_process_ring_four_cards_ms": r["r1"]["four_cards_ms"],
                         "sp_process_lora_step_ms": r["r2"]["ms"], "sp_process_lora_host_ms": r["r2"]["host_ms"],
                         "sp_process_lora_busy": r["r2"]["busy"], "sp_process_lora_peak_gib": r["r2"]["peak_gib"],
                         "sp_process_lora_nccl_ms": r["r2"]["nccl_ms"],
                         "sp_process_lora_nccl_count": r["r2"]["nccl_count"],
                         "sp_process_lora_launches": r["r2"]["launches"], "sp_process_ring_bytes": r["r2"]["ring_bytes"],
                         "sp_process_lora_grad_rel_diff": r["r2"]["grad_rel decoder + LoRA"],
                         "sp_process_lora_lora_grad_rel_diff": r["r2"]["grad_rel LoRA alone"],
                         "sp_2d_lora_step_ms": r["r3"]["ms"], "sp_2d_lora_host_ms": r["r3"]["host_ms"],
                         "sp_2d_lora_busy": r["r3"]["busy"], "sp_2d_lora_peak_gib": r["r3"]["peak_gib"],
                         "sp_2d_lora_grad_rel_diff": r["r3"]["grad_rel decoder + LoRA"],
                         "reference_bs4": r["reference_bs4"], "reference_bs8": r["reference_bs8"]}))
        _log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    if args.only_q4:
        smi = phase_device()
        if torch.cuda.device_count() < 4:
            print(f"chip_smoke: --only-q4 needs 4 CUDA devices, {torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        phase_build()
        devices = [torch.device("cuda", i) for i in range(4)]
        sp = phase_sp_extract(args.seed, devices[0], devices)
        sp_lora = phase_sp_lora(args.seed, devices[0], devices)
        tp = phase_tp_cards(args.seed, devices)
        _log(json.dumps({"card": smi, "sp_extract_ms": sp["ms"], "sp_extract_peak_gib": sp["peak_gib"],
                         "sp_lora_step_ms": sp_lora["ms"][0], "unsharded_lora_step_ms": sp_lora["ms"][1],
                         "sp_lora_peak_gib": sp_lora["peak_gib SP"],
                         "unsharded_lora_peak_gib": sp_lora["peak_gib unsharded"], "tp_ms": tp["ms"],
                         "tp_peak_gib": tp["peak_gib"]}))
        _log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0
    if args.only_p3:
        smi = phase_device()
        if torch.cuda.device_count() < 2:
            print(f"chip_smoke: --only-p3 needs 2 CUDA devices, {torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        phase_build()
        dev = torch.device("cuda", 0)
        phase_dp_p3(smi, _train_world(dev, phase_pseudo_labels(args.seed, dev, smi)))
        _log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0

    started = time.perf_counter()
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
    tp_cls = phase_tp_cls(args.seed, dev, _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None),
                          smi)
    k7 = phase_k7(gen, dev, fe8)
    del fe8
    torch.cuda.empty_cache()
    sp_kernels = phase_sp_kernels(gen, dev)
    sp = phase_sp_extract(args.seed, dev, [dev] * 4)
    torch.cuda.empty_cache()
    sp_lora = phase_sp_lora(args.seed, dev, [dev] * 4)
    torch.cuda.empty_cache()
    dots = phase_remat_dots(args.seed, dev)
    torch.cuda.empty_cache()
    evalk = phase_eval(args.seed, dev, smi, numpy_scorer=args.numpy_scorer)
    torch.cuda.empty_cache()
    pl = phase_pseudo_labels(args.seed, dev, smi)
    torch.cuda.empty_cache()
    train = phase_train(args.seed, dev, smi, pl)
    torch.cuda.empty_cache()
    coral = phase_coral(args.seed, dev, smi, pl)
    torch.cuda.empty_cache()
    coral_train = phase_coral_train(args.seed, dev, smi, pl)
    torch.cuda.empty_cache()
    dp = phase_dp(smi, evalk, train)
    torch.cuda.empty_cache()
    proto = phase_prototypes(args.seed, dev)
    torch.cuda.empty_cache()
    variants_t = phase_attention_variants(args.seed, dev)
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
        "eval_native_scored": evalk["first"]["scored"]["native"],
        "eval_metrics_s_native": evalk["second"]["split"]["metrics"],
        "eval_metrics_s_numpy": evalk["numpy"]["split"]["metrics"] if "numpy" in evalk else None,
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
        "tp_cls_attention_max_abs_err": tp_cls["err_cls_attention"],
        "tp_cls_key_tokens_max_abs_err": tp_cls["err_key_tokens"], "tp_cls_mask_differ": tp_cls["mask_differ"],
        "coral_train_cache_build_img_per_s": coral_train["build_img_per_s"],
        "coral_train_steps_per_s": coral_train["steps_per_s"], "coral_train_step_ms": coral_train["step_ms"],
        "coral_train_step_host_ms": coral_train["step_host_ms"], "coral_train_step_peak_gib": coral_train["peak_gib"],
        "coral_train_epoch_device_busy": coral_train["busy"],
        "dp_p1_decoder_steps_per_s": dp["p1_rate"], "dp_no_group_decoder_steps_per_s": dp["p0_rate"],
        "dp_run_a_decoder_steps_per_s": dp["run_a_rate"], "dp_p1_epoch_device_busy": dp["p1_busy"],
        "dp_p1_max_abs_diff_vs_run_a": dp["p1_diff_a"], "dp_eval_img_per_s": dp["p2_img_s"],
        "dp_eval_max_abs_diff_vs_phase_k": dp["p2_diff_k"], "dp_p3_decoder_steps_per_s": dp.get("p3_rate"),
        "dp_p3_nccl_ms_per_epoch": dp.get("p3_nccl_ms"),
        "sp_extract_ms": sp["ms"], "sp_features_max_abs_err": sp["err"], "sp_extract_peak_gib": sp["peak_gib"],
        "sp_lora_step_ms": sp_lora["ms"][0], "unsharded_756_lora_step_ms": sp_lora["ms"][1],
        "sp_lora_grad_rel_diff": sp_lora["grad_rel decoder + LoRA"],
        "sp_lora_lora_grad_rel_diff": sp_lora["grad_rel LoRA alone"],
        "sp_lora_peak_gib": sp_lora["peak_gib SP"], "unsharded_756_lora_peak_gib": sp_lora["peak_gib unsharded"],
        "remat_step_ms": dots["ms"], "remat_peak_gib": dots["peak_gib"], "remat_dots_grad_rel_diff": dots["grad_rel"],
        "remat_dots_grad_max_diff": dots["grad_max_diff"],
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
    # (phase N), CORAL stage 2's training run A (phase O) and the TP CLS
    # attention call (phase I; K5's port is K1 on the shard layout, so K5
    # takes K1's count there, as its launches do)
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
                "refine_int8_launches": coral["serve_int8_launches"].get(key, 0),
                "coral_train_launches": coral_train["launches"].get(key, 0),
                "dp_train_launches": dp["p1_launches"].get(key, 0), "dp_eval_launches": dp["p2_launches"].get(key, 0),
                "tp_cls_launches": tp_cls["launches"].get("K1" if kid == "K5" else key, 0),
                "sp_launches": sp["launches"]["seq=4 756px"].get(key, 0),
                "sp_lora_launches": sp_lora["launches"].get(key, 0), **device}

    def sp_chunk(kid):
        """K2 and K3/K4 at the ring's 756px chunk, (4, 730, 768), f32 out (phase Q0)."""
        ms, plain_ms = sp_kernels[kid]
        return {"sp_chunk_ms": ms, "sp_chunk_plain_ms": plain_ms, "sp_chunk_bound_ms": sp_kernels[f"{kid}_bound"][0],
                "sp_chunk_bound_by": sp_kernels[f"{kid}_bound"][1], "sp_chunk_library_ms": sp_kernels[f"{kid}_sdpa"],
                "sp_chunk_max_abs_err": sp_kernels["err"]["fwd_lse" if kid == "K2" else "bwd"]}

    attn, fused = "ucod_dpl_tpu/ops/attention.py", "ucod_dpl_tpu/ops/fused_layers.py"
    _log(f"default run: {time.perf_counter() - started:.1f} s from the device check to the kernels line, "
         f"build included")
    _log(json.dumps({"kernels": [
        # K1 and K6: launches on the eval entry's first run (cache build and
        # crop pass), beside those of the serving phase
        entry("K1", "packed attention forward", "attention_fwd.cu", f"{attn}:87",
              evalk["first"]["launches"]["K1"], k1_err, *times["K1"], times["sdpa_fwd"],
              serving_launches=launches["K1"]),
        entry("K2", "attention forward with log-sum-exp", "attention_fwd.cu", f"{attn}:309",
              train_launches["fwd_lse"], grad_err["fwd_lse"], *train_times["fwd_lse"], times["sdpa_fwd"],
              **sp_chunk("K2")),
        entry("K3", "attention backward from the log-sum-exp (one backward with K4)", "attention_bwd.cu",
              f"{attn}:440", train_launches["bwd"], grad_err["bwd"], *train_times["bwd"], train_times["sdpa_bwd"],
              **sp_chunk("K3")),
        entry("K4", "KV-blocked attention backward (one backward with K3)", "attention_bwd.cu",
              f"{attn}:684,716", train_launches["bwd"], grad_err["bwd"], *train_times["bwd"], train_times["sdpa_bwd"],
              **sp_chunk("K3")),
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
        *_prototype_entries(proto),
        *_variant_entries(variants_t),
    ]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
