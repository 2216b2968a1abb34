"""The UCOD-DPL Dual-Branch Adversarial decoder (``RevDecoder``) and the
prediction it serves, in plain float32 PyTorch, NCHW.

Features are resized bilinearly (``align_corners=False``) to the decoder's
grid, then a 1x1 convolution decouples them into two branches of
``embed_dim`` channels; each branch is scaled by its learnable embedding and
L2-normalised over the tokens, the attention ``sigmoid(f * d) + d`` feeds a
1x1 convolution to one logit, and the orthogonality loss is the mean square
of the off-diagonal of ``f1 f2^T`` over (B, L, L).  A prediction is the
foreground logit upsampled bilinearly to the image and passed through a
sigmoid.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of the last two axes of an NCHW tensor."""
    if x.shape[-2:] == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)


def _conv1x1(x, w, b):
    return F.conv2d(x, w[:, :, None, None], b)


def forward(
    dec: Dict[str, torch.Tensor], feats: torch.Tensor, size: int, *, with_loss: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(B, D, h, w) features -> (fg, bg) logits (B, 1, size, size) and the
    orthogonality loss (None unless ``with_loss``)."""
    x = _conv1x1(resize(feats, size), dec["decoupling_w"], dec["decoupling_b"])
    e = x.shape[1] // 2
    d1, d2 = x[:, :e], x[:, e:]
    b = x.shape[0]
    emb = dec["learnable_embedding"]
    f1 = F.normalize((d1 * emb[0][None, :, None, None]).reshape(b, e, -1), dim=2, eps=1e-12)
    f2 = F.normalize((d2 * emb[1][None, :, None, None]).reshape(b, e, -1), dim=2, eps=1e-12)
    ortho = None
    if with_loss:
        m = torch.bmm(f1.transpose(1, 2), f2)  # (B, L, L)
        off = m - torch.diag_embed(torch.diagonal(m, dim1=1, dim2=2))
        ortho = (off * off).mean()
    att1 = torch.sigmoid(f1.reshape_as(d1) * d1) + d1
    att2 = torch.sigmoid(f2.reshape_as(d2) * d2) + d2
    fg = _conv1x1(att1, dec["conv_out_fg_w"], dec["conv_out_fg_b"])
    bg = _conv1x1(att2, dec["conv_out_bg_w"], dec["conv_out_bg_b"])
    return fg, bg, ortho


def probabilities(dec, key_features_nhwc: torch.Tensor, feature_size: int, image_size: int) -> torch.Tensor:
    """(B, h, w, D) key features -> (B, image_size, image_size) foreground
    probabilities."""
    fg, _, _ = forward(dec, key_features_nhwc.permute(0, 3, 1, 2), feature_size)
    return torch.sigmoid(resize(fg, image_size))[:, 0]
