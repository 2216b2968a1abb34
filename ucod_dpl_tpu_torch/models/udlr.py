"""UDLR SparseRefiner (CORAL stage 2), jax-free: EntropySelector, the CSF
cross-attention of HRE, and the GatedEnsembler.

Counterpart of :mod:`ucod_dpl_tpu.models.udlr` (the reference's
``models/UDLR.py``, ``models/modules/{ASR,HRE,CSF,GE_pix_level}.py`` and
the cross-attention block of ``models/modules/mlp.py``), in the JAX
package's fixed-shape formulation: every one of the ``window_size**2``
windows runs through CSF in one batched call and the windows the entropy
gate does not select are masked out of the (non-overlapping) canvas.

Parameters are held in the reference checkpoint's own layouts (linears
``(out, in)``, the in-projection ``(3E, E)``, the depthwise kernel ``(E, 1,
7, 7)``, 1x1 convolutions as ``(out, in)`` matrices), so loading and saving
a reference-format safetensors file only drops and restores the 1x1 tail.
Everything here is plain float32 PyTorch, as the JAX package leaves it to
XLA: no kernel of the port runs in the refiner.  The training losses are
ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ucod_dpl_tpu_torch.ops.resize import adaptive_avg_pool2d, avg_pool2d, interpolate_bilinear

Params = Dict[str, Any]


# -- init ---------------------------------------------------------------------

def init_sparse_refiner(seed: int, dim: int = 768) -> Params:
    """Seeded float32 refiner parameters (``numpy.random.default_rng(seed)``,
    as :func:`~ucod_dpl_tpu_torch.models.dino.init_dino`), drawn from the
    distributions of the JAX package's init: xavier-uniform in-projection,
    uniform(+-1/sqrt(fan_in)) linears, unit LayerNorms, zero biases where it
    has them, ``GE.alpha`` 0.5.  Another stream than ``jax.random``, so the
    values differ from the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    e = dim

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    def uniform(shape, bound):
        return t(rng.uniform(-bound, bound, size=shape))

    def linear(d_in, d_out):
        s = 1.0 / np.sqrt(d_in)
        return {"w": uniform((d_out, d_in), s), "b": uniform((d_out,), s)}

    def ln(d):
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    csf = {
        "attn": {
            "norm_q": ln(e),
            "norm_kv": ln(e),
            "in_proj_w": uniform((3 * e, e), np.sqrt(6.0 / (e + e))),
            "in_proj_b": torch.zeros(3 * e),
            "out": linear(e, e),
            "norm_mlp": ln(e),
            "fc1": linear(e, 4 * e),
            "fc2": linear(4 * e, e),
        },
        "dw_conv": {"w": uniform((e, 1, 7, 7), np.sqrt(6.0 / (49 * 6))), "b": torch.zeros(e)},
        "mask_dec": linear(e, 1),
    }
    ge = {"alpha": torch.tensor(0.5), "fuser0": linear(1, 64), "fuser2": linear(64, 1)}
    return {"csf": csf, "ge": ge}


# -- forward pieces --------------------------------------------------------------

def _layernorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(x, p["w"], p["b"])


def _mha(q, kv, in_proj_w, in_proj_b, out, num_heads: int) -> torch.Tensor:
    """torch ``nn.MultiheadAttention`` (batch_first) cross-attention as plain
    f32 products and a softmax, in the JAX package's order."""
    b, lq, e = q.shape
    lk = kv.shape[1]
    hd = e // num_heads
    wq, wk, wv = in_proj_w[:e], in_proj_w[e : 2 * e], in_proj_w[2 * e :]
    bq, bk, bv = in_proj_b[:e], in_proj_b[e : 2 * e], in_proj_b[2 * e :]
    qh = F.linear(q, wq, bq).reshape(b, lq, num_heads, hd)
    kh = F.linear(kv, wk, bk).reshape(b, lk, num_heads, hd)
    vh = F.linear(kv, wv, bv).reshape(b, lk, num_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, lq, e)
    return _dense(ctx, out)


def cross_attention_block(p: Params, query: torch.Tensor, context: torch.Tensor, num_heads: int) -> torch.Tensor:
    """CrossAttentionBlock (``mlp.py:116-148``): pre-norm cross-attention
    and an exact-GELU MLP, each with its residual."""
    x = query + _mha(_layernorm(query, p["norm_q"]), _layernorm(context, p["norm_kv"]), p["in_proj_w"],
                     p["in_proj_b"], p["out"], num_heads)
    h = F.gelu(_dense(_layernorm(x, p["norm_mlp"]), p["fc1"]))
    return x + _dense(h, p["fc2"])


def csf_forward(p: Params, l_inputs: torch.Tensor, h_inputs: torch.Tensor, num_heads: int) -> torch.Tensor:
    """CSF (``CSF.py:38-43``): cross-attention with the high-res window as
    query and the low-res features as context, a depthwise 7x7 and the 1x1
    mask head.  NHWC (N, H, W, C) in, (N, H, W, 1) out."""
    n, h, w, c = h_inputs.shape
    out = cross_attention_block(p["attn"], h_inputs.reshape(n, h * w, c), l_inputs.reshape(n, -1, c), num_heads)
    out = F.conv2d(out.reshape(n, h, w, c).permute(0, 3, 1, 2), p["dw_conv"]["w"], p["dw_conv"]["b"], padding=3,
                   groups=c).permute(0, 2, 3, 1)
    return _dense(out, p["mask_dec"])


def entropy_select(preds: torch.Tensor, window_size: int, threshold: float):
    """EntropySelector (``ASR.py:41-51``): the mean prediction entropy of each
    of the ``window_size**2`` windows.  ``preds`` (B, H, W, 1), probabilities
    when the whole batch lies in [0, 1], else logits.  Returns (mask (B, ws,
    ws) bool, entropy (B, H, W, 1))."""
    in_range = bool(((preds >= 0) & (preds <= 1)).all())
    probs = preds if in_range else torch.sigmoid(preds)
    entropy = -probs * torch.log(probs.clamp_min(1e-5))
    scores = adaptive_avg_pool2d(entropy.permute(0, 3, 1, 2), (window_size, window_size))[:, 0]
    return scores > threshold, entropy


def gated_ensemble(p: Params, l1: torch.Tensor, l2: torch.Tensor):
    """GatedEnsembler (``GE_pix_level.py:16-26``): the coarse logits ``l1``
    resized to ``l2``'s grid, blended with ``l2`` by a gate of the local
    foreground entropy (normalised by its batch-global max, as the
    reference) and the global foreground ratio, then the 1x1 fuser.  (B, H,
    W, 1) logits in; (fused, weight) out."""
    h, w = l2.shape[1:3]
    l1 = interpolate_bilinear(l1.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
    probs = torch.sigmoid(l1)
    fg_g = probs.mean(dim=(1, 2, 3), keepdim=True)
    fg_l = avg_pool2d(probs.permute(0, 3, 1, 2), 19, stride=1, padding=9).permute(0, 2, 3, 1)
    en = -fg_l * torch.log(fg_l.clamp_min(1e-5))
    en = 1.0 - en / en.max()
    weight = (en + fg_g) / 2.0
    y = l1 * weight + l2 * (1.0 - weight)
    return _dense(torch.relu(_dense(y, p["fuser0"])), p["fuser2"]), weight


class RefinerOutput(NamedTuple):
    outputs: torch.Tensor  # (B, H*ws, W*ws, 1) fused logits
    h_preds: torch.Tensor  # (B, H*ws, W*ws, 1) the selected windows' predictions on the canvas
    window_preds: torch.Tensor  # (B*ws^2, h, w, 1) every window's prediction
    mask: torch.Tensor  # (B, ws, ws) the selected windows
    entropy: torch.Tensor
    ge_weight: torch.Tensor


def sparse_refiner_forward(
    params: Params,
    l_features: torch.Tensor,
    h_features: torch.Tensor,
    preds: torch.Tensor,
    window_size: int,
    threshold: float,
    num_heads: int = 8,
) -> RefinerOutput:
    """SparseRefiner.forward (``UDLR.py:77-86``) in the fixed-shape form:
    ``l_features`` (B, h, w, C), ``h_features`` (B, ws^2, h, w, C) per
    window, ``preds`` (B, h, w, 1) the coarse prediction."""
    b, ws2, h, w, c = h_features.shape
    ws = window_size
    if ws2 != ws * ws:
        raise ValueError(f"h_features holds {ws2} windows; window_size {ws} needs {ws * ws}")
    mask, entropy = entropy_select(preds, ws, threshold)

    # every window through CSF at once, each with its image's l-features as context
    l_rep = torch.repeat_interleave(l_features, ws2, dim=0)
    window_preds = csf_forward(params["csf"], l_rep, h_features.reshape(b * ws2, h, w, c), num_heads)

    # the windows tile the canvas without overlap, so the reference's
    # scatter-average is a masked reshape; unselected tiles get 0 / (0 + 1e-6)
    sel = mask.reshape(b, ws, ws, 1, 1, 1).to(window_preds.dtype)
    canvas = (window_preds.reshape(b, ws, ws, h, w, 1) * sel).permute(0, 1, 3, 2, 4, 5).reshape(b, ws * h, ws * w, 1)
    denom = (mask.reshape(b, ws, ws, 1, 1).float() + 1e-6).expand(b, ws, ws, h, w)
    denom = denom.permute(0, 1, 3, 2, 4).reshape(b, ws * h, ws * w, 1)
    h_preds = canvas / denom
    outputs, ge_w = gated_ensemble(params["ge"], preds, h_preds)
    return RefinerOutput(outputs, h_preds, window_preds, mask, entropy, ge_w)


def _training_half(name: str):
    def loss(*args, **kwargs):
        raise NotImplementedError(f"{name}, a UDLR training loss, is ROADMAP Queue 1 item 15's training half")

    loss.__name__ = name
    loss.__doc__ = f"The JAX package's ``models/udlr.py::{name}``: not ported yet (raises)."
    return loss


# the training losses (JAX models/udlr.py:234-364) wait for item 15's training half
binary_iou_batch = _training_half("binary_iou_batch")
refiner_distillation_loss = _training_half("refiner_distillation_loss")
refiner_ensemble_loss = _training_half("refiner_ensemble_loss")
refiner_train_loss = _training_half("refiner_train_loss")


# -- checkpoints -------------------------------------------------------------------

# reference tensor name -> (path in the params, 1x1 convolution stored (out, in, 1, 1))
_NAME_MAP = {
    "HRE.CSF.attn.norm_q.weight": (("csf", "attn", "norm_q", "scale"), False),
    "HRE.CSF.attn.norm_q.bias": (("csf", "attn", "norm_q", "bias"), False),
    "HRE.CSF.attn.norm_kv.weight": (("csf", "attn", "norm_kv", "scale"), False),
    "HRE.CSF.attn.norm_kv.bias": (("csf", "attn", "norm_kv", "bias"), False),
    "HRE.CSF.attn.attn.in_proj_weight": (("csf", "attn", "in_proj_w"), False),
    "HRE.CSF.attn.attn.in_proj_bias": (("csf", "attn", "in_proj_b"), False),
    "HRE.CSF.attn.attn.out_proj.weight": (("csf", "attn", "out", "w"), False),
    "HRE.CSF.attn.attn.out_proj.bias": (("csf", "attn", "out", "b"), False),
    "HRE.CSF.attn.norm_mlp.weight": (("csf", "attn", "norm_mlp", "scale"), False),
    "HRE.CSF.attn.norm_mlp.bias": (("csf", "attn", "norm_mlp", "bias"), False),
    "HRE.CSF.attn.mlp.0.weight": (("csf", "attn", "fc1", "w"), False),
    "HRE.CSF.attn.mlp.0.bias": (("csf", "attn", "fc1", "b"), False),
    "HRE.CSF.attn.mlp.2.weight": (("csf", "attn", "fc2", "w"), False),
    "HRE.CSF.attn.mlp.2.bias": (("csf", "attn", "fc2", "b"), False),
    "HRE.CSF.depthwise_conv.weight": (("csf", "dw_conv", "w"), False),
    "HRE.CSF.depthwise_conv.bias": (("csf", "dw_conv", "b"), False),
    "HRE.CSF.mask_dec.weight": (("csf", "mask_dec", "w"), True),
    "HRE.CSF.mask_dec.bias": (("csf", "mask_dec", "b"), False),
    "GE.alpha": (("ge", "alpha"), False),
    "GE.fuser.0.weight": (("ge", "fuser0", "w"), True),
    "GE.fuser.0.bias": (("ge", "fuser0", "b"), False),
    "GE.fuser.2.weight": (("ge", "fuser2", "w"), True),
    "GE.fuser.2.bias": (("ge", "fuser2", "b"), False),
}


def load_refiner_checkpoint(path: str) -> Params:
    """A reference-format SparseRefiner safetensors file -> float32 params on
    the CPU; a file that lacks any of the refiner's tensors raises."""
    from safetensors.torch import load_file

    flat = load_file(path)
    missing = [name for name in _NAME_MAP if name not in flat]
    if missing:
        raise ValueError(f"Refiner checkpoint {path} is missing {len(missing)}/{len(_NAME_MAP)} tensors (e.g. "
                         f"{missing[:3]}); is this a SparseRefiner checkpoint?")
    params: Params = {}
    for name, (keys, conv1) in _NAME_MAP.items():
        arr = flat[name].float()
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = (arr[:, :, 0, 0] if conv1 else arr).contiguous()
    return params


def save_refiner_checkpoint(path: str, params: Params) -> None:
    """Write ``params`` in the reference's safetensors names and layouts
    (atomically)."""
    from ucod_dpl_tpu_torch.models.safetensors_io import save_file_atomic

    flat = {}
    for name, (keys, conv1) in _NAME_MAP.items():
        node = params
        for k in keys:
            node = node[k]
        arr = node.detach().to("cpu", torch.float32)
        if arr.dim() == 0:  # GE.alpha: the JAX package's files hold it as (1,)
            arr = arr.reshape(1)
        flat[name] = (arr[:, :, None, None] if conv1 else arr).contiguous()
    save_file_atomic(flat, path)
