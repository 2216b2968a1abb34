"""Dual-Branch Adversarial (DBA) decoder in PyTorch.

Counterpart of :mod:`ucod_dpl_tpu.models.dba` (itself the reference
``RevDecoder``, ``models/modules/DBA.py:5-59``).  NHWC layout; every 1x1
convolution is a channel matmul with its weight in the PyTorch ``(out, in)``
layout (the reference checkpoint's OIHW kernel without its 1x1 tail).  The
decoder body runs in float32.  The orthogonality loss uses the O(C^2)
reformulation ``||F1 F2^T||_F^2 = sum((F1^T F1) * (F2^T F2))``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear_nhwc
from ucod_dpl_tpu_torch.utils.profiling import annotate

EMBED_DIM = 64


class RevDecoderParams(NamedTuple):
    """Parameters of one decoder tower (student or EMA teacher)."""

    decoupling_w: torch.Tensor  # (2*EMBED_DIM, feature_dim)
    decoupling_b: torch.Tensor  # (2*EMBED_DIM,)
    learnable_embedding: torch.Tensor  # (2, EMBED_DIM)
    conv_out_fg_w: torch.Tensor  # (1, EMBED_DIM)
    conv_out_fg_b: torch.Tensor  # (1,)
    conv_out_bg_w: torch.Tensor  # (1, EMBED_DIM)
    conv_out_bg_b: torch.Tensor  # (1,)


def init_rev_decoder(seed: int, feature_dim: int = 768) -> RevDecoderParams:
    """torch ``nn.Conv2d`` default init (uniform +-1/sqrt(fan_in) for the 1x1
    weights and biases) and a standard-normal embedding, from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    def conv(fan_in, fan_out):
        s = 1.0 / np.sqrt(fan_in)
        return t(rng.uniform(-s, s, (fan_out, fan_in))), t(rng.uniform(-s, s, (fan_out,)))

    dw, db = conv(feature_dim, 2 * EMBED_DIM)
    fw, fb = conv(EMBED_DIM, 1)
    bw, bb = conv(EMBED_DIM, 1)
    emb = t(rng.standard_normal((2, EMBED_DIM)))
    return RevDecoderParams(dw, db, emb, fw, fb, bw, bb)


def orthogonal_loss_from_features(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Mean over (B, L, L) of the squared off-diagonal of ``f1 @ f2^T``,
    from two (C, C) Grams and an (L,) row-dot."""
    b, l, _ = f1.shape
    g1 = torch.einsum("blc,bld->bcd", f1, f1)
    g2 = torch.einsum("blc,bld->bcd", f2, f2)
    fro_sq = torch.sum(g1 * g2, dim=(1, 2))
    diag_sq = torch.sum(torch.sum(f1 * f2, dim=-1) ** 2, dim=-1)
    return torch.sum(fro_sq - diag_sq) / (b * l * l)


def _decoder_body(
    params: RevDecoderParams, decoupled: torch.Tensor, *, with_loss: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    b, h, w, _ = decoupled.shape
    l = h * w
    d1, d2 = decoupled.chunk(2, dim=-1)
    # scale by the branch embedding, then L2-normalise over the TOKEN axis
    # (the reference normalises dim=1 of (B, L, C); F.normalize's eps)
    f1 = F.normalize((d1 * params.learnable_embedding[0]).reshape(b, l, EMBED_DIM), dim=1, eps=1e-12)
    f2 = F.normalize((d2 * params.learnable_embedding[1]).reshape(b, l, EMBED_DIM), dim=1, eps=1e-12)
    ortho = orthogonal_loss_from_features(f1, f2) if with_loss else None
    att1 = torch.sigmoid(f1.reshape(b, h, w, EMBED_DIM) * d1) + d1
    att2 = torch.sigmoid(f2.reshape(b, h, w, EMBED_DIM) * d2) + d2
    fg = F.linear(att1, params.conv_out_fg_w, params.conv_out_fg_b)
    bg = F.linear(att2, params.conv_out_bg_w, params.conv_out_bg_b)
    return fg, bg, ortho


def _decouple(params: RevDecoderParams, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x.float(), params.decoupling_w, params.decoupling_b)


def rev_decoder_forward(params: RevDecoderParams, x: torch.Tensor, *, with_loss: bool = True):
    """(B, H, W, feature_dim) features -> (fg_logits, bg_logits, ortho_loss);
    logits are (B, H, W, 1)."""
    return _decoder_body(params, _decouple(params, x), with_loss=with_loss)


def rev_decoder_forward_resized(
    params: RevDecoderParams, feats: torch.Tensor, size: int, *, with_loss: bool = False
):
    """``rev_decoder_forward(interpolate(feats, size))`` with the 1x1
    decoupling hoisted before the bilinear resize (the two commute, and the
    row-stochastic resize passes the bias through exactly)."""
    decoupled = interpolate_bilinear_nhwc(_decouple(params, feats), (size, size))
    return _decoder_body(params, decoupled, with_loss=with_loss)


def key_decoupling_fold(
    k_w: torch.Tensor, k_b: torch.Tensor, params: RevDecoderParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-compose the ViT's last key projection (``(out, in)`` weight) with
    the decoupling: ``decouple(ln(x) Wk^T + bk) == ln(x) (Wd Wk)^T + (Wd bk + bd)``.
    Computed in float32; returns ``(w (2E, hidden), b (2E,))``."""
    wd = params.decoupling_w.float()
    return wd @ k_w.float(), wd @ k_b.float() + params.decoupling_b.float()


def rev_decoder_forward_decoupled(
    params: RevDecoderParams,
    decoupled: torch.Tensor,
    size: Optional[int],
    *,
    with_loss: bool = False,
):
    """Decoder body on an already-decoupled (B, h, w, 2E) map, bilinear-resized
    to (size, size) first; ``size=None`` keeps the native grid."""
    decoupled = decoupled.float()
    if size is not None:
        decoupled = interpolate_bilinear_nhwc(decoupled, (size, size))
    return _decoder_body(params, decoupled, with_loss=with_loss)


def fg_logits_live(
    backbone_params,
    params: RevDecoderParams,
    pixels: torch.Tensor,
    dino_cfg,
    *,
    compute_dtype: torch.dtype,
    size: Optional[int] = None,
    plain: bool = False,
    quant=None,
    int8_mlp: str = "split",
):
    """pixels -> decoder logits through the folded live-inference path: the
    ViT with the decoupling folded into its last key projection, then the
    decoder body at ``size`` (``None`` = the native patch grid).  The hot
    composition of serving and the LookTwice crop pass.  ``plain=True`` runs
    the plain PyTorch versions of the kernels.  ``quant`` (int8 linears from
    ``ops.quant.quantize_dino_linears``) takes the W8A8 backbone, its MLP half
    as ``int8_mlp`` says (``dino_forward``); the decoder body stays float32."""
    from ucod_dpl_tpu_torch.models.dino import dino_forward

    with annotate("model.fg_logits_live"):
        last_k = backbone_params["layers"][-1]["k"]
        fold = key_decoupling_fold(last_k["w"], last_k["b"], params)
        out = dino_forward(
            backbone_params, pixels, dino_cfg, compute_dtype=compute_dtype, key_fold=fold, plain=plain,
            quant=quant, int8_mlp=int8_mlp,
        )
        return rev_decoder_forward_decoupled(params, out["folded_features"], size)
