"""The DINO ViT in plain float32 PyTorch.

DINOv2 (``facebook/dinov2-base``, arXiv:2304.07193) and DINOv1 ViT-B/8
(``facebook/dino-vitb8``, arXiv:2104.14294) as HuggingFace's ``Dinov2Model``
and ``ViTModel`` compute them: a patch convolution, the CLS token, position
embeddings resized bicubically (``align_corners=False``) to the patch grid,
pre-norm blocks of multi-head softmax attention and an exact-GELU MLP, with
layerscale in DINOv2.  UCOD-DPL reads the last block's key projection (its
hook), so the last block runs LayerNorm 1 and the key projection only.
Weights come as the benchmark's parameter tree (``harness/weights.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Matmul, fp8_round


def _linear(x, p, mm: Matmul):
    return mm(x, p["w"]) + p["b"]


def _layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _attention(q, k, v, heads: int, mm: Matmul):
    b, l, d = q.shape
    hd = d // heads

    def split(x):
        return x.reshape(b, l, heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    probs = torch.softmax(mm(q, k) * hd ** -0.5, dim=-1)
    o = mm(probs, v.transpose(-1, -2))
    return o.transpose(1, 2).reshape(b, l, d)


def position_embeddings(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(1, 1 + n, D) table -> (1, 1 + gh * gw, D), the patch rows resized
    bicubically to the grid (HuggingFace's ``interpolate_pos_encoding``)."""
    n = pos.shape[1] - 1
    side = int(round(n ** 0.5))
    if side * side == gh * gw and side == gh:
        return pos
    grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def key_tokens(
    w: Dict[str, Any],
    pixels: torch.Tensor,
    cfg: Dict[str, Any],
    *,
    mm: Matmul = Matmul(),
) -> torch.Tensor:
    """(B, H, W, 3) normalised pixels -> the last block's key projection of
    every token, (B, 1 + N, D) float32."""
    p, heads, eps = cfg["patch_size"], cfg["num_heads"], cfg["layer_norm_eps"]
    b, h, wd, _ = pixels.shape
    gh, gw = h // p, wd // p
    kern = w["patch_embed"]["kernel"]
    if mm.fp8:
        x = F.conv2d(fp8_round(pixels.permute(0, 3, 1, 2)), fp8_round(kern), w["patch_embed"]["bias"], stride=p)
    else:
        x = F.conv2d(pixels.permute(0, 3, 1, 2), kern, w["patch_embed"]["bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([w["cls_token"].expand(b, 1, -1), x], dim=1) + position_embeddings(w["pos_embed"], gh, gw)
    layers = w["layers"]

    for i, layer in enumerate(layers[:-1]):
        y = _layer_norm(x, layer["norm1"], eps)
        q = _linear(y, layer["q"], mm)
        k = _linear(y, layer["k"], mm)
        v = _linear(y, layer["v"], mm)
        a = _linear(_attention(q, k, v, heads, mm), layer["out"], mm)
        if "ls1" in layer:
            a = a * layer["ls1"]
        x = x + a
        y = F.gelu(_linear(_layer_norm(x, layer["norm2"], eps), layer["fc1"], mm))
        y = _linear(y, layer["fc2"], mm)
        if "ls2" in layer:
            y = y * layer["ls2"]
        x = x + y
    last = len(layers) - 1
    y = _layer_norm(x, layers[last]["norm1"], eps)
    return _linear(y, layers[last]["k"], mm)


def key_features(w, pixels, cfg, **kw) -> torch.Tensor:
    """The key projection of the patch tokens as a (B, gh, gw, D) map."""
    k = key_tokens(w, pixels, cfg, **kw)
    p = cfg["patch_size"]
    return k[:, 1:].reshape(pixels.shape[0], pixels.shape[1] // p, pixels.shape[2] // p, -1)
