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
  4. K6 (fused LayerNorm + q/k/v) against its plain version;
  5. serving: a full-width dinov2-base Predictor at 518px (seeded random
     weights) answers requests of 16, 5 and 1 images (buckets 16, 8, 1) and
     one soft request; K1 and K6 each launch 11 times per forward;
  6. composed accuracy: ``fg_logits_live`` through the kernels in bf16 is no
     further from the float32 plain path than the bf16 plain path is
     (err <= 1.5 * err_plain + 1e-3);
  7. timing with CUDA events: K1 and K6 against their plain versions at the
     serving shape, and the port's ``fg_logits_live`` img/s at bs16 518px.
The second-to-last line is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and cuDNN.
"""

from __future__ import annotations

import argparse
import json
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
SERVE_DIM = 768
NUM_HEADS = 12


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
        # the last 64-row tile is mostly padding: a missing key mask or a
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
    for b, l in ((16, 1370), (3, 257)):
        x, norm, lins = _lnqkv_inputs(gen, dev, b, l)
        outs = layernorm_qkv(x, norm, *lins, 1e-6, out=tuple(_nan_like(x) for _ in range(3)))
        torch.cuda.synchronize()
        refs = layernorm_qkv_reference(x, norm, *lins, 1e-6)
        for which, o, r in zip("qkv", outs, refs):
            tol = K6_TOL * r.float().abs().max().item()
            worst = max(worst, _check(f"bs{b} L{l} {which}", o, r, tol))
    return worst


def _serving_model(seed: int, dev):
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder

    fe_cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = FeatureExtractor(fe_cfg, device=dev, seed=seed, strict=False)
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
    packed_attention.launches = 0
    layernorm_qkv.launches = 0
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
    return {"K1": packed_attention.launches, "K6": layernorm_qkv.launches}


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
    from ucod_dpl_tpu_torch.ops.fused_layers import layernorm_qkv, layernorm_qkv_reference

    dev = fe.device
    _log("timing (CUDA events, interleaved plain/kernel/kernel/plain, bf16):")
    q, k, v = (torch.randn(16, 1370, SERVE_DIM, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    k1_ms, k1_plain = _ab_ms(lambda: packed_attention_reference(q, k, v, NUM_HEADS, 0.125),
                             lambda: packed_attention(q, k, v, NUM_HEADS, 0.125), 20)
    _log(f"  K1 bs16 L1370 12x64: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms")
    x, norm, lins = _lnqkv_inputs(gen, dev, 16, 1370)
    k6_ms, k6_plain = _ab_ms(lambda: layernorm_qkv_reference(x, norm, *lins, 1e-6),
                             lambda: layernorm_qkv(x, norm, *lins, 1e-6), 20)
    _log(f"  K6 bs16 L1370 768->3x768: kernel {k6_ms:.4f} ms, plain {k6_plain:.4f} ms")

    dec = params_to(decoder, dev)
    px = torch.randn(16, 518, 518, 3, generator=gen, device=dev)
    with torch.inference_mode():
        def fwd(plain):
            return lambda: fg_logits_live(fe.params, dec, px, fe.config, compute_dtype=torch.bfloat16,
                                          size=68, plain=plain)

        fwd_ms, fwd_plain = _ab_ms(fwd(True), fwd(False), 5)
    _log(f"  fg_logits_live bs16 518px bf16: kernels {fwd_ms:.3f} ms = {16e3 / fwd_ms:.2f} img/s; "
         f"plain {fwd_plain:.3f} ms = {16e3 / fwd_plain:.2f} img/s")
    return {"K1": (k1_ms, k1_plain), "K6": (k6_ms, k6_plain),
            "fg_logits_live_img_per_s": 16e3 / fwd_ms, "fg_logits_live_plain_img_per_s": 16e3 / fwd_plain}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights and inputs")
    args = parser.parse_args(argv)

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k1_err = phase_k1(gen, dev)
    k6_err = phase_k6(gen, dev)
    fe, decoder = _serving_model(args.seed, dev)
    launches = phase_serving(fe, decoder, args.seed)
    phase_composed(fe, decoder, args.seed)
    times = phase_timing(fe, decoder, gen)
    _log(json.dumps({
        "fg_logits_live_img_per_s": times["fg_logits_live_img_per_s"],
        "fg_logits_live_plain_img_per_s": times["fg_logits_live_plain_img_per_s"],
        "batch": 16, "image": 518, "dtype": "bfloat16",
    }))
    _log(json.dumps({"kernels": [
        {"name": "K1 packed attention forward", "route": "cuda",
         "source": "ucod_dpl_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "ucod_dpl_tpu/ops/attention.py:87", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K6 fused LayerNorm + q/k/v", "route": "cuda",
         "source": "ucod_dpl_tpu_torch/csrc/layernorm_qkv.cu",
         "replaces": "ucod_dpl_tpu/ops/fused_layers.py:33", "launches": launches["K6"],
         "max_abs_err": k6_err, "ms": times["K6"][0], "plain_ms": times["K6"][1]},
    ]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
