"""The ViT patch embed as one im2col GEMM with a bias and position epilogue.

:func:`patch_embed` (K13, ``csrc/patch_embed.cu``) is the port of the TPU
prototypes ``scripts/microbench/bench_patch_embed.py::pallas_patch`` and
``pallas_patch2`` and ``bench_patch_embed3.py::pallas_im2col``: NHWC pixels
cut into 14 x 14 patches, each patch's (p, q, c) values times the (588, D)
weight, plus the bias (and the position embedding), rounded once.  Its
plain version :func:`patch_embed_reference` does the same arithmetic.
:func:`pqc_weight` maps the port's (D, 3, 14, 14) convolution kernel to that
weight.  A timing tool and a ``chip_smoke.py`` phase call it; no product
path does (``models/dino.py::_embed`` runs a convolution).

Dispatch is by device alone: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ucod_dpl_tpu_torch.ops import _build

PATCH = 14  # the kernel's patch size (3 channels)


def pqc_weight(kernel: torch.Tensor) -> torch.Tensor:
    """The (D, C, p, p) convolution kernel (``patch_embed.kernel``) as the
    (p * p * C, D) im2col weight in (p, q, c) row order."""
    d = kernel.shape[0]
    return kernel.permute(2, 3, 1, 0).reshape(-1, d)


def im2col(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p * p * C): row-major patches, each in
    (p, q, c) order."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels[:, :gh * patch, :gw * patch].reshape(b, gh, patch, gw, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)


def patch_embed_reference(
    pixels: torch.Tensor, weight_pqc: torch.Tensor, bias: torch.Tensor, pos: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of :func:`patch_embed` in the weight's dtype: pixels
    rounded to it, the im2col matrix times the weight accumulated in f32,
    ``+ bias`` (``+ pos``) in f32, one rounding."""
    dtype = weight_pqc.dtype
    c = pixels.shape[-1]
    patch = round((weight_pqc.shape[0] // c) ** 0.5)
    y = torch.matmul(im2col(pixels.to(dtype), patch).float(), weight_pqc.float()) + bias.float().reshape(-1)
    if pos is not None:
        y = y + pos.float().reshape(y.shape[1:])
    return y.to(dtype)


def patch_embed(
    pixels: torch.Tensor,
    weight_pqc: torch.Tensor,
    bias: torch.Tensor,
    pos: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, W, 3) pixels -> (B, H/14 * W/14, D) patch tokens ``im2col(pixels)
    @ weight_pqc + bias (+ pos)``, ``weight_pqc`` the (588, D) weight of
    :func:`pqc_weight`, ``pos`` the (H/14 * W/14, D) position rows; written
    into ``out`` when given.

    CUDA tensors launch K13 (counted in ``patch_embed.launches``): f32
    pixels with H and W multiples of 14, a bf16 weight with D % 256 == 0, an
    f32 bias, a bf16 ``pos``; out bf16.  CPU tensors take
    :func:`patch_embed_reference`."""
    if pixels.device.type == "cpu":
        ref = patch_embed_reference(pixels, weight_pqc, bias, pos)
        return ref if out is None else out.copy_(ref)
    what = "patch_embed"
    if pixels.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {pixels.device}")
    if pixels.dim() != 4 or pixels.shape[-1] != 3 or pixels.shape[1] % PATCH or pixels.shape[2] % PATCH \
            or pixels.shape[1] < PATCH or pixels.shape[2] < PATCH:
        raise ValueError(f"{what} kernel needs (B, H, W, 3) pixels with H and W multiples of {PATCH}; got "
                         f"{tuple(pixels.shape)}")
    if pixels.dtype != torch.float32 or not pixels.is_contiguous() or pixels.data_ptr() % 8:
        raise ValueError(f"{what} kernel needs contiguous 8-byte aligned f32 pixels; got {pixels.dtype}")
    b, h, w, _ = pixels.shape
    n = h // PATCH * (w // PATCH)
    d = weight_pqc.shape[-1]
    for name, t, dtype, shape, align in (("weight_pqc", weight_pqc, torch.bfloat16, (PATCH * PATCH * 3, d), 16),
                                         ("bias", bias, torch.float32, (d,), 8),
                                         ("pos", pos, torch.bfloat16, (n, d), 4)):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != pixels.device or not t.is_contiguous() \
                or t.data_ptr() % align:
            raise ValueError(f"{what} kernel needs a contiguous {dtype} {name} of shape {shape} on "
                             f"{pixels.device}; got {t.dtype} {tuple(t.shape)}@{t.device}")
    if d % 256:
        raise ValueError(f"{what} kernel needs D % 256 == 0; got {d}")
    if out is None:
        out = torch.empty(b, n, d, device=pixels.device, dtype=torch.bfloat16)
    elif out.dtype != torch.bfloat16 or out.shape != (b, n, d) or out.device != pixels.device \
            or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"{what} kernel writes a contiguous 16-byte aligned bf16 ({b}, {n}, {d}) out on "
                         f"{pixels.device}; got {out.dtype} {tuple(out.shape)}@{out.device}")
    with torch.cuda.device(pixels.device):
        err = _build.kernels().ucod_patch_embed(
            pixels.data_ptr(), weight_pqc.data_ptr(), bias.data_ptr(), 0 if pos is None else pos.data_ptr(),
            out.data_ptr(), b, h, w, d, torch.cuda.current_stream(pixels.device).cuda_stream,
        )
    _build.check_cuda(err, what)
    patch_embed.launches += 1
    return out


patch_embed.launches = 0
