"""DINO ViT feature extractor in PyTorch (DINOv2 ``dinov2-base`` and DINOv1
``dino-vitb8`` architectures).

Counterpart of :mod:`ucod_dpl_tpu.models.dino`: plain functions over a
params dict whose names follow the JAX pytree, in PyTorch layouts
(patch kernel OIHW, linears ``(out, in)``; :mod:`.convert` maps between the
two).  The forward returns the last block's key projection (the reference's
hook contract) or, with ``key_fold``, the key projection pre-composed with
the decoder's decoupling.

On a CUDA device the fused LayerNorm + q/k/v (K6) and the packed attention
(K1) run as hand-written kernels in bf16; ``plain=True`` runs their plain
PyTorch versions instead, on any device.  Attention
(:func:`~ucod_dpl_tpu_torch.ops.attention.multi_head_attention`) runs every
head count of a head dim in 16-128 through the packed forward on the card,
where the JAX package splits odd counts to its per-head kernel K5 (the same
function).  ``tp_shard`` runs the
tensor-parallel forward, heads and MLP expansion split over a mesh axis,
``sp_shard`` the sequence-parallel one, tokens split over a mesh axis and
attention as a ring of the forward-with-log-sum-exp kernel, and both
together the 2D forward (:func:`_sharded_forward`).  With ``quant`` (the opt-in int8
serving path, :func:`~ucod_dpl_tpu_torch.ops.quant.quantize_dino_linears`)
the linears of layers 0..n-2 run through the int8 kernels K8 (LN + q/k/v),
K10 (out-projection) and K9 (LN + fc1 + GELU, then fc2 as a plain int8
product) or, with ``int8_mlp="whole"``, K11 (the whole MLP half).  The differentiated forward
(``differentiable=True``, what LoRA training runs) takes the routing of the
JAX package's ``differentiable_mode``: LayerNorm and three dense
projections in place of K6 (which has no backward), and attention through
:func:`~ucod_dpl_tpu_torch.ops.attention.packed_attention_diff` (the
forward with log-sum-exp and the flash backward kernels).  A float32
forward on CUDA is full float32 only with ``torch.backends.cudnn.allow_tf32 = False`` (the patch
embed is a cuDNN convolution) and ``torch.backends.cuda.matmul.allow_tf32 =
False`` (PyTorch's default).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ucod_dpl_tpu_torch.ops.attention import differentiable_attention, multi_head_attention, tp_multi_head_attention
from ucod_dpl_tpu_torch.ops import fused_layers as FL
from ucod_dpl_tpu_torch.ops.fused_layers import dense, layer_norm, layernorm_qkv, layernorm_qkv_reference
from ucod_dpl_tpu_torch.ops.quant import dense_w8a8, dense_w8a8_pre, quantize_linear
from ucod_dpl_tpu_torch.ops.resize import interpolate_bicubic
from ucod_dpl_tpu_torch.parallel.distributed import LOCAL, all_gather_tokens, model_parallel_input, model_parallel_sum
from ucod_dpl_tpu_torch.parallel.sp import chunk_kv_lens, gather_tokens, ring_attention, sp_param_grid, split_tokens
from ucod_dpl_tpu_torch.parallel.tp import place_model_row, to_devices
from ucod_dpl_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True)
class DinoConfig:
    variant: str = "dinov2"  # "dinov1" | "dinov2"
    image_size: int = 518
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    use_layerscale: bool = True  # dinov2 only

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def dinov2_base() -> "DinoConfig":
        return DinoConfig(variant="dinov2", image_size=518, patch_size=14,
                          layer_norm_eps=1e-6, use_layerscale=True)

    @staticmethod
    def dinov1_vitb8() -> "DinoConfig":
        return DinoConfig(variant="dinov1", image_size=224, patch_size=8,
                          layer_norm_eps=1e-12, use_layerscale=False)

    @staticmethod
    def from_type(type_name: str) -> "DinoConfig":
        if type_name == "dinov2":
            return DinoConfig.dinov2_base()
        if type_name == "dinov1":
            return DinoConfig.dinov1_vitb8()
        raise ValueError(f"Unknown feature extractor type: {type_name}")


# ---------------------------------------------------------------------------
# init / weight conversion
# ---------------------------------------------------------------------------

def init_dino(seed: int, cfg: DinoConfig, device: torch.device | str = "cpu") -> Dict[str, Any]:
    """Random-init params from ``numpy.random.default_rng(seed)`` with the
    JAX ``init_dino`` distributions (the numbers differ: other generator)."""
    rng = np.random.default_rng(seed)
    d = cfg.hidden_size
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    def normal(*shape, std=0.02):
        return t(rng.standard_normal(shape, dtype=np.float32) * std)

    def linear(d_in, d_out):
        s = 1.0 / np.sqrt(d_in)
        return {"w": t(rng.uniform(-s, s, (d_out, d_in))), "b": t(rng.uniform(-s, s, (d_out,)))}

    def norm():
        return {"scale": t(np.ones(d)), "bias": t(np.zeros(d))}

    params: Dict[str, Any] = {
        "patch_embed": {"kernel": normal(d, 3, cfg.patch_size, cfg.patch_size), "bias": t(np.zeros(d))},
        "cls_token": normal(1, 1, d),
        "pos_embed": normal(1, n_pos, d),
        "layers": [],
        "final_norm": norm(),
    }
    for _ in range(cfg.num_layers):
        layer = {
            "norm1": norm(),
            "q": linear(d, d), "k": linear(d, d), "v": linear(d, d), "out": linear(d, d),
            "norm2": norm(),
            "fc1": linear(d, d * cfg.mlp_ratio), "fc2": linear(d * cfg.mlp_ratio, d),
        }
        if cfg.use_layerscale:
            layer["ls1"] = t(np.ones(d))
            layer["ls2"] = t(np.ones(d))
        params["layers"].append(layer)
    return params


def _hf_names(cfg: DinoConfig) -> Dict[str, str]:
    if cfg.variant == "dinov2":
        return {"norm1": "norm1", "norm2": "norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    return {"norm1": "layernorm_before", "norm2": "layernorm_after",
            "fc1": "intermediate.dense", "fc2": "output.dense"}


def convert_hf_state_dict(sd: Dict[str, Any], cfg: DinoConfig) -> Dict[str, Any]:
    """HuggingFace Dinov2Model / ViTModel state dict (numpy or torch values)
    -> params.  HF already stores PyTorch layouts, so tensors only move."""
    names = _hf_names(cfg)

    def t(key):
        return torch.as_tensor(np.asarray(sd[key], dtype=np.float32)).clone()

    def lin(prefix):
        return {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    params: Dict[str, Any] = {
        "patch_embed": {"kernel": t("embeddings.patch_embeddings.projection.weight"),
                        "bias": t("embeddings.patch_embeddings.projection.bias")},
        "cls_token": t("embeddings.cls_token"),
        "pos_embed": t("embeddings.position_embeddings"),
        "layers": [],
        "final_norm": ln("layernorm"),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        layer = {
            "norm1": ln(f"{p}.{names['norm1']}"),
            "q": lin(f"{p}.attention.attention.query"),
            "k": lin(f"{p}.attention.attention.key"),
            "v": lin(f"{p}.attention.attention.value"),
            "out": lin(f"{p}.attention.output.dense"),
            "norm2": ln(f"{p}.{names['norm2']}"),
            "fc1": lin(f"{p}.{names['fc1']}"),
            "fc2": lin(f"{p}.{names['fc2']}"),
        }
        if cfg.use_layerscale:
            layer["ls1"] = t(f"{p}.layer_scale1.lambda1")
            layer["ls2"] = t(f"{p}.layer_scale2.lambda1")
        params["layers"].append(layer)
    return params


def load_hf_checkpoint(path: str, cfg: DinoConfig) -> Dict[str, Any]:
    """Params from a local HuggingFace checkpoint directory or file
    (``model.safetensors`` or ``pytorch_model.bin``); no network access."""
    if os.path.isdir(path):
        for cand in ("model.safetensors", "pytorch_model.bin"):
            f = os.path.join(path, cand)
            if os.path.exists(f):
                path = f
                break
        else:
            raise FileNotFoundError(f"No model weights found under {path}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    for pref in ("vit.", "dinov2.", "model."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):] if k.startswith(pref) else k: v for k, v in sd.items()}
    return convert_hf_state_dict({k: v.float().numpy() for k, v in sd.items()}, cfg)


def export_hf_state_dict(params: Dict[str, Any], cfg: DinoConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_hf_state_dict`: params -> a HuggingFace-layout
    state dict (Dinov2Model / ViTModel key names) of contiguous float32 CPU
    tensors, which round-trips exactly through :func:`load_hf_checkpoint`."""
    names = _hf_names(cfg)

    def t(x):
        # safetensors writes the raw buffer: contiguous copies only
        return x.detach().to("cpu", torch.float32).contiguous()

    sd = {
        "embeddings.patch_embeddings.projection.weight": t(params["patch_embed"]["kernel"]),
        "embeddings.patch_embeddings.projection.bias": t(params["patch_embed"]["bias"]),
        "embeddings.cls_token": t(params["cls_token"]),
        "embeddings.position_embeddings": t(params["pos_embed"]),
        "layernorm.weight": t(params["final_norm"]["scale"]),
        "layernorm.bias": t(params["final_norm"]["bias"]),
    }
    hf_linears = {"q": "attention.attention.query", "k": "attention.attention.key",
                  "v": "attention.attention.value", "out": "attention.output.dense",
                  "fc1": names["fc1"], "fc2": names["fc2"]}
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{p}.{names[norm]}.weight"] = t(layer[norm]["scale"])
            sd[f"{p}.{names[norm]}.bias"] = t(layer[norm]["bias"])
        for name, hf in hf_linears.items():
            sd[f"{p}.{hf}.weight"] = t(layer[name]["w"])
            sd[f"{p}.{hf}.bias"] = t(layer[name]["b"])
        if cfg.use_layerscale:
            sd[f"{p}.layer_scale1.lambda1"] = t(layer["ls1"])
            sd[f"{p}.layer_scale2.lambda1"] = t(layer["ls2"])
    return sd


def save_hf_checkpoint(path: str, params: Dict[str, Any], cfg: DinoConfig) -> None:
    """Write params as a HuggingFace-layout ``.safetensors`` file."""
    from ucod_dpl_tpu_torch.models.safetensors_io import save_file_atomic

    save_file_atomic(export_hf_state_dict(params, cfg), path)


def cast_params(params: Dict[str, Any], dtype: torch.dtype, qkv_masters: bool = False) -> Dict[str, Any]:
    """Params for a forward in ``dtype``, cast once instead of at every call.

    What meets a ``dtype`` operand goes to ``dtype``: the matmul weights, the
    patch-embed, out-projection and MLP biases, the layerscales and the CLS
    token.  What the numerics need in float32 stays float32: the LayerNorm
    parameters (f32 statistics), the q/k/v biases (K6 adds them in f32), the
    position embedding (interpolated in f32 for other grids) and the last
    layer, of which the forward runs only LN1 and the key projection (which
    ``key_fold`` pre-composes in f32).  ``qkv_masters`` keeps the q/k/v
    weights in float32 too: LoRA training merges its adapters into them in
    float32 at every step (a bf16 weight would swallow the small delta) and
    the forward casts the merged weight to ``dtype``."""

    def cast_layer(layer):
        out = {}
        for name, p in layer.items():
            if name in ("norm1", "norm2"):
                out[name] = p
            elif name in ("q", "k", "v"):
                out[name] = {"w": p["w"] if qkv_masters else p["w"].to(dtype), "b": p["b"]}
            elif isinstance(p, dict):
                out[name] = {k: t.to(dtype) for k, t in p.items()}
            else:
                out[name] = p.to(dtype)
        return out

    return {
        "patch_embed": {k: t.to(dtype) for k, t in params["patch_embed"].items()},
        "cls_token": params["cls_token"].to(dtype),
        "pos_embed": params["pos_embed"],
        "layers": [cast_layer(layer) for layer in params["layers"][:-1]] + params["layers"][-1:],
        "final_norm": params["final_norm"],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid_hw: Tuple[int, int], orig_grid: int
) -> torch.Tensor:
    """HF-compatible bicubic interpolation of (1, 1+N, D) position embeddings
    to an (h, w) patch grid; the CLS position passes through."""
    h, w = grid_hw
    if h == w and h * w == pos_embed.shape[1] - 1:
        return pos_embed
    d = pos_embed.shape[-1]
    patch_pos = pos_embed[:, 1:].reshape(1, orig_grid, orig_grid, d).permute(0, 3, 1, 2)
    patch_pos = interpolate_bicubic(patch_pos.float(), (h, w))
    patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, h * w, d)
    return torch.cat([pos_embed[:, :1], patch_pos.to(pos_embed.dtype)], dim=1)


def _embed(params, pixels: torch.Tensor, cfg: DinoConfig, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) pixels -> (B, 1 + gh*gw, D) tokens with CLS and position."""
    b, img_h, img_w, _ = pixels.shape
    gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
    x = F.conv2d(
        pixels.to(dtype).permute(0, 3, 1, 2),
        params["patch_embed"]["kernel"].to(dtype),
        stride=cfg.patch_size,
    )
    x = x.flatten(2).transpose(1, 2) + params["patch_embed"]["bias"].to(dtype)
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    orig_grid = int(round((params["pos_embed"].shape[1] - 1) ** 0.5))
    return x + interpolate_pos_embed(params["pos_embed"], (gh, gw), orig_grid).to(dtype)


def _remat_mode(remat) -> str:
    """True/"layer" -> "layer", False/"none"/"" -> "none", "dots" (the JAX
    modes)."""
    if isinstance(remat, str):
        if remat in ("none", ""):
            return "none"
        if remat in ("layer", "dots"):
            return remat
        raise ValueError(f"remat={remat!r}: expected False/'none', True/'layer', or 'dots'")
    return "layer" if remat else "none"


# The "dots" policy (the JAX ``dots_with_no_batch_dims_saveable``): the
# outputs of the 2-D products are saved, i.e. the q/k/v, out, fc1 and fc2
# projections (``F.linear`` of a (B, L, D) activation is one ``aten.mm`` on
# its (B * L, D) view); everything else in the layer is recomputed in the
# backward: the LayerNorms, casts, bias adds, layerscales, GELU, residual
# adds and the attention autograd Function (its forward with log-sum-exp
# runs again, 2 launches a layer per step as under "layer").
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, remat):
    """``fn`` under the remat mode: as is ("none"), saving only its inputs
    and recomputing it in the backward ("layer"), or saving the outputs of
    its 2-D products and recomputing the rest ("dots")."""
    mode = _remat_mode(remat)
    if mode == "none":
        return fn
    kwargs = {"context_fn": _dots_context} if mode == "dots" else {}

    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)

    return run


def dino_forward(
    params: Dict[str, Any],
    pixels: torch.Tensor,
    cfg: DinoConfig,
    *,
    compute_dtype: torch.dtype = torch.float32,
    key_fold: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    plain: bool = False,
    differentiable: bool = False,
    remat=False,
    quant: Optional[Dict[str, Any]] = None,
    int8_mlp: str = "split",
    tp_shard: Optional[Tuple[Any, str]] = None,
    sp_shard: Optional[Tuple[Any, str]] = None,
    want_cls_attention: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the ViT and return the reference hook contract.

    The last layer computes only LN1 and its key projection (eager PyTorch
    cannot drop unused work the way XLA does, so the port never starts it),
    and with ``want_cls_attention`` the query of the CLS row.

    Args:
      params: dict from :func:`init_dino` / :func:`load_hf_checkpoint`, on the
        device of ``pixels``.
      pixels: (B, H, W, 3) normalised image batch, NHWC.
      key_fold: optional ``(w, b)`` with ``w: (F, hidden)``, ``b: (F,)``: the
        last layer then computes ``dense(LN1(x), (w, b))`` in place of its key
        projection (the key projection pre-composed with a downstream linear
        map, e.g. the DBA decoder's decoupling).
      plain: run the plain PyTorch versions of the kernels on any device.
      differentiable: the forward that is differentiated (the JAX
        ``differentiable_mode``): q/k/v by LayerNorm + three dense
        projections, attention through ``packed_attention_diff`` where
        ``packed_layout_ok`` (on CUDA at head dims 64 and 128; another
        raises), else (and when ``plain``) autograd through the plain
        version (``ops.attention.differentiable_attention``); under
        ``tp_shard`` per model shard, by its heads.
      remat: ``False``/``"none"`` saves every activation for the backward;
        ``True``/``"layer"`` saves only each layer's input and recomputes the
        layer in the backward (``torch.utils.checkpoint``); ``"dots"`` saves
        the outputs of the layer's projections and recomputes the rest
        (selective checkpointing, :data:`_DOTS_SAVED`).
      quant: int8 linears from ``quantize_dino_linears`` (of the float32
        weights): the W8A8 forward, inference only.  The last layer's key
        projection or ``key_fold`` (quantized at each call) becomes a plain
        int8 product; norms, layerscales and embeddings come from ``params``.
      int8_mlp: with ``quant``, ``"split"`` runs the MLP half as K9 and an
        int8 fc2 product, ``"whole"`` as K11 (the JAX package's
        ``UCOD_INT8_WHOLE_MLP=1``).
      tp_shard: ``(mesh, axis)``: the tensor-parallel forward (the JAX
        ``tp_shard``), heads and the MLP expansion split over ``axis``;
        ``params`` is then the list of that axis's shards from
        :func:`~ucod_dpl_tpu_torch.parallel.tp.shard_dino_params` (one row of
        it) or one dict (placed here, differentiably, on this process's
        first data coordinate: what ``lora_forward`` passes), each on its
        own device (see :func:`_sharded_forward`).  With ``differentiable``
        each shard's attention is routed by its heads.  Not with ``quant``
        (ValueError).
      sp_shard: ``(mesh, axis)``: the sequence-parallel forward (the JAX
        ``sp_shard``): the tokens padded to the ring size and split over
        ``axis``, every token-local operation on its chunk's device and
        attention by :func:`~ucod_dpl_tpu_torch.parallel.sp.ring_attention`
        (the forward with log-sum-exp per chunk pair, and its backward
        under ``differentiable``).  ``params``: one dict (placed here on
        data coordinate 0's devices, differentiably) or the per-chunk list
        of :func:`~ucod_dpl_tpu_torch.parallel.sp.sp_param_grid` (rows of
        model shards with ``tp_shard``).  On a mesh over processes each
        process runs its own chunks and its first data coordinate, and the
        ring crosses processes; every process of the ring calls this at the
        same point with the same pixels.  With ``tp_shard`` on the same mesh
        it is the 2D forward, heads and MLP split over ``tp_shard``'s axis
        inside each chunk; that axis may cross processes too (one model
        coordinate a process; see :func:`_sharded_forward`).  Not with
        ``want_cls_attention`` or ``quant`` (ValueError).
      want_cls_attention: also return the last layer's attention
        probabilities of the CLS row over the 1+N keys (the pseudo-label
        generator's input): its query ``LN1(x)[:, :1] @ Wq + b``, the logits
        against every key in ``compute_dtype``, scaled and softmaxed in f32,
        as the JAX package computes them.  Plain ``torch`` products, as the
        JAX package leaves them to XLA; layers before the last run as
        always.  Not with ``key_fold`` or ``quant`` (ValueError).  Under
        ``tp_shard`` each shard computes its own heads' rows.

    Returns ``key_tokens`` (B, 1+N, hidden) and ``key_features`` (B, h, w,
    hidden), with ``want_cls_attention`` also ``cls_attention`` (B, heads,
    1+N) float32; with ``key_fold`` only ``folded_features`` (B, h, w, F).
    """
    if want_cls_attention:
        if key_fold is not None:
            raise ValueError("key_fold skips the last layer's q projection; CLS attention needs key_fold=None")
        if quant is not None:
            raise ValueError("pseudo-label generation is a parity contract; CLS attention runs on the "
                             "full-precision forward (quant=None)")
    if sp_shard is not None:
        if tp_shard is not None and tp_shard[0] is not sp_shard[0]:
            raise ValueError("sp_shard + tp_shard must share one Mesh (2D-sharded attention rings tokens and "
                             "shards heads on the same device grid)")
        if want_cls_attention:
            raise ValueError("pseudo-label generation is a bitwise parity contract; run it on the unsharded "
                             "forward")
        if quant is not None:
            raise ValueError("int8 path is single-chip; sp_shard shards tokens")
    if tp_shard is not None and quant is not None:
        raise ValueError("the int8 path is single-device; tp_shard shards the weights (needs quant=None)")
    with annotate("model.dino_forward"):
        if sp_shard is not None or tp_shard is not None:
            return _sharded_forward(params, pixels, cfg, tp_shard, sp_shard, dtype=compute_dtype, plain=plain,
                                    differentiable=differentiable, remat=remat, key_fold=key_fold,
                                    want_cls_attention=want_cls_attention)
        b, img_h, img_w, _ = pixels.shape
        gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
        dtype = compute_dtype
        eps = cfg.layer_norm_eps
        scale = 1.0 / float(np.sqrt(cfg.head_dim))
        if quant is not None:
            if differentiable:
                raise ValueError("the int8 path is inference-only; differentiable=True needs quant=None")
            if int8_mlp not in ("split", "whole"):
                raise ValueError(f"int8_mlp must be 'split' or 'whole'; got {int8_mlp!r}")
            if len(quant["layers"]) != len(params["layers"]):
                raise ValueError(f"quant has {len(quant['layers'])} layers, params {len(params['layers'])}")
        if differentiable:
            def attention(q, k, v, nh, scale):
                return differentiable_attention(q, k, v, nh, scale, plain=plain)

            def ln_qkv(x, norm, q, k, v, eps):
                h = layer_norm(x, norm, eps)
                return dense(h, q, dtype), dense(h, k, dtype), dense(h, v, dtype)
        else:
            ln_qkv = layernorm_qkv_reference if plain else layernorm_qkv

            def attention(q, k, v, nh, scale):
                return multi_head_attention(q, k, v, nh, scale, plain=plain)

        def block_int8(x, layer, q8):
            ln_qkv8 = FL.layernorm_qkv_w8a8_reference if plain else FL.layernorm_qkv_w8a8
            q, k, v = ln_qkv8(x, layer["norm1"], q8["q"], q8["k"], q8["v"], eps)
            attn = attention(q, k, v, cfg.num_heads, scale)
            attn = (FL.dense_quant_w8a8_reference if plain else FL.dense_quant_w8a8)(attn, q8["out"], dtype)
            if cfg.use_layerscale:
                attn = attn * layer["ls1"].to(dtype)
            x = x + attn
            if int8_mlp == "whole":
                mlp = FL.layernorm_mlp_w8a8_reference if plain else FL.layernorm_mlp_w8a8
                h = mlp(x, layer["norm2"], q8["fc1"], q8["fc2"], eps)
            else:
                fc1 = FL.layernorm_fc1_gelu_w8a8_reference if plain else FL.layernorm_fc1_gelu_w8a8
                h = dense_w8a8_pre(*fc1(x, layer["norm2"], q8["fc1"], eps), q8["fc2"], dtype)
            if cfg.use_layerscale:
                h = h * layer["ls2"].to(dtype)
            return x + h

        def block(x, layer):
            q, k, v = ln_qkv(x, layer["norm1"], layer["q"], layer["k"], layer["v"], eps)
            attn = attention(q, k, v, cfg.num_heads, scale)
            attn = dense(attn, layer["out"], dtype)
            if cfg.use_layerscale:
                attn = attn * layer["ls1"].to(dtype)
            x = x + attn
            h = dense(layer_norm(x, layer["norm2"], eps), layer["fc1"], dtype)
            if dtype == torch.bfloat16:
                # tanh-approx GELU in bf16, exact erf in f32 (the JAX split)
                h = F.gelu(h, approximate="tanh")
            else:
                h = F.gelu(h.float()).to(dtype)
            h = dense(h, layer["fc2"], dtype)
            if cfg.use_layerscale:
                h = h * layer["ls2"].to(dtype)
            return x + h

        run_block = _remat(block, remat)

        x = _embed(params, pixels, cfg, dtype)
        *layers, last = params["layers"]
        for i, layer in enumerate(layers):
            x = run_block(x, layer) if quant is None else block_int8(x, layer, quant["layers"][i])

        # the last layer: LN1, then the key projection or the fold (int8: a
        # plain int8 product, as the JAX package leaves it to XLA; the fold
        # weight depends on the decoder, so it is quantized here, at each call)
        h = layer_norm(x, last["norm1"], eps)
        if key_fold is not None:
            fw, fb = key_fold
            fold = {"w": fw, "b": fb}
            folded = dense(h, fold, dtype) if quant is None else dense_w8a8(h, quantize_linear(fold), dtype)
            return {"folded_features": folded[:, 1:].reshape(b, gh, gw, fw.shape[0])}
        k = dense(h, last["k"], dtype) if quant is None else dense_w8a8(h, quant["layers"][-1]["k"], dtype)
        out = {"key_tokens": k, "key_features": k[:, 1:].reshape(b, gh, gw, cfg.hidden_size)}
        if want_cls_attention:
            out["cls_attention"] = _cls_attention(h, k, last["q"], cfg.num_heads, cfg.head_dim, scale, dtype)
        return out


def _cls_attention(h, k, q, num_heads: int, head_dim: int, scale: float, dtype) -> torch.Tensor:
    """The last layer's CLS-row attention probabilities (B, heads, 1+N)
    float32: the row's query ``LN1(x)[:, :1] @ Wq + b`` ((B, 1, heads, d))
    against the keys ``k`` (B, 1+N, heads * d), logits in ``dtype`` (the JAX
    einsum on ``dtype`` operands returns ``dtype``), then cast to f32,
    scaled and softmaxed per head.  Head-local: a tensor-parallel shard
    passes its own q columns and keys."""
    b = h.shape[0]
    qh = dense(h[:, :1], q, dtype).reshape(b, 1, num_heads, head_dim)
    kh = k.reshape(b, -1, num_heads, head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() * scale
    return torch.softmax(logits, dim=-1)[:, :, 0, :]


def _param_grid(params, tp_shard, sp_shard):
    """``grid[a][m]``: the params of this process's ``a``-th token chunk and
    ``m``-th model shard (one chunk without ``sp_shard``, one shard without
    ``tp_shard``; every shard of the axis when it stays in the process)."""
    if sp_shard is None:
        mesh, axis = tp_shard
        if isinstance(params, dict):
            return [place_model_row(params, mesh, axis)]
        held = len(mesh.local_block()[axis])
        if len(params) != held:
            raise ValueError(f"tp_shard over {axis}={mesh.shape[axis]} needs {held} parameter shards; "
                             f"got {len(params)}")
        return [list(params)]
    mesh, axis = sp_shard
    if isinstance(params, dict):
        return sp_param_grid(params, mesh, axis, None if tp_shard is None else tp_shard[1])
    block = mesh.local_block()
    held = len(block[axis])
    if len(params) != held:
        raise ValueError(f"sp_shard over {axis}={mesh.shape[axis]} needs a parameter row per chunk this process "
                         f"holds ({held}); got {len(params)}")
    grid = [[row] if isinstance(row, dict) else list(row) for row in params]
    tp = 1 if tp_shard is None else len(block[tp_shard[1]])
    if any(len(row) != tp for row in grid):
        raise ValueError(f"the 2D forward needs {tp} model shards per chunk")
    return grid


def _sharded_forward(
    params,
    pixels: torch.Tensor,
    cfg: DinoConfig,
    tp_shard: Optional[Tuple[Any, str]],
    sp_shard: Optional[Tuple[Any, str]],
    *,
    dtype: torch.dtype,
    plain: bool,
    differentiable: bool = False,
    remat=False,
    key_fold: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    want_cls_attention: bool = False,
) -> Dict[str, torch.Tensor]:
    """The tensor-parallel, sequence-parallel and 2D forwards of
    :func:`dino_forward` (JAX ``dino_forward(tp_shard=..., sp_shard=...)``)
    over ``grid[i][m]``, the params of token chunk ``i`` (one without
    ``sp_shard``; on a mesh over processes, this process's chunks) and model
    shard ``m`` (one without ``tp_shard``; this process's shards), each on
    its own device.

    Every layer is unfused, as in JAX (LayerNorm, then dense per shard; K6
    never runs).  Under ``sp_shard`` the embedded tokens are padded to the
    ring size and split into chunks (:func:`~ucod_dpl_tpu_torch.parallel.
    sp.split_tokens`); the residual chunk ``i`` lives on the device of its
    shard 0, and every token-local operation runs per chunk.  The
    column-parallel q/k/v and fc1 products stay on their shards; attention
    runs per shard through :func:`tp_multi_head_attention` (one chunk) or
    as the ring of :func:`~ucod_dpl_tpu_torch.parallel.sp.ring_attention`
    over the chunks, each model shard ringing its own heads.  The
    row-parallel out-projection and fc2 products are partial sums: each
    shard's product is rounded to ``dtype`` (bf16 partials), the partials
    are added in f32 in shard order on the chunk's home device and rounded
    once, and the bias is added after that reduce (with one shard this is
    the unsharded dense).  Each shard reads the residual stream from its
    home device, so it is identical on every shard and the result is
    deterministic; where a chunk's shards sit on several cards of the
    process, the stream and every parameter read on more than one of them
    are copied there by :func:`~ucod_dpl_tpu_torch.parallel.tp.to_devices`,
    whose backward adds the copies' gradients in shard order, so the
    gradients are deterministic too.  Work that is replicated (LayerNorm of the residual
    stream) runs once per distinct device.  The last layer computes LN1 and
    the key projection (gathered from the shards) or the key fold, per
    chunk; the chunks are gathered on the first chunk's device (on a mesh
    over processes, every process embeds the whole image, keeps its own
    chunks, and gathers the others' last over the ring's subgroup, the
    backward keeping its own slice) and the padding sliced off.  With
    ``want_cls_attention`` (tensor parallelism alone) each shard also takes
    its heads' CLS-row query and attention (:func:`_cls_attention`, the
    unsharded path's rounding), and the heads are concatenated in shard
    order.  Under ``differentiable`` each shard's
    attention is routed as :func:`~ucod_dpl_tpu_torch.ops.attention.
    differentiable_attention` routes it.

    A model axis across processes (one or more model coordinates a
    process): every process of a model line holds the chunk's residual
    stream; the partial sums of every shard of the line are gathered over
    the line's subgroup and folded left in f32 in shard order before the
    rounding (:func:`~ucod_dpl_tpu_torch.parallel.distributed.
    model_parallel_sum`: the subgroup's ranks follow the coordinate), the
    one-process forward's sum bit for bit; the LayerNorm outputs enter the
    shards' products through :func:`~ucod_dpl_tpu_torch.parallel.
    distributed.model_parallel_input` (their gradients summed over the
    line); the last layer's key shards and CLS attention heads are
    gathered over the line in shard order.  Every process of the line then
    holds the same output and, for a loss computed from it on every
    process, the whole gradient of every replicated tensor."""
    grid = _param_grid(params, tp_shard, sp_shard)
    n, tp = len(grid), len(grid[0])
    model_group = LOCAL if tp_shard is None else tp_shard[0].group(tp_shard[1])
    tp_total = 1 if tp_shard is None else tp_shard[0].shape[tp_shard[1]]
    devs = [[p["pos_embed"].device for p in row] for row in grid]
    home = [row[0] for row in devs]
    b, img_h, img_w, _ = pixels.shape
    gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
    eps = cfg.layer_norm_eps
    scale = 1.0 / float(np.sqrt(cfg.head_dim))

    def shard_input(i, x, norm):
        """LN(x) of chunk i on each shard's device (computed once per
        distinct device), as the shards' products' input; x reaches the
        chunk's cards through one ``to_devices``, so its copies' gradients
        are summed in shard order."""
        xs_on = to_devices(x, devs[i])
        ln: Dict[torch.device, torch.Tensor] = {}
        for m, d in enumerate(devs[i]):
            if d not in ln:
                ln[d] = layer_norm(xs_on[m], norm[m], eps)
        entered = dict(zip(ln, model_parallel_input(list(ln.values()), model_group)))
        return [entered[d] for d in devs[i]]

    def reduce(i, partials, bias):
        acc = model_parallel_sum([p.to(home[i]).float() for p in partials], model_group)
        return acc.to(dtype) + bias.to(dtype)

    def gelu(h):
        # tanh-approx GELU in bf16, exact erf in f32 (the JAX split)
        return F.gelu(h, approximate="tanh") if dtype == torch.bfloat16 else F.gelu(h.float()).to(dtype)

    x = _embed(grid[0][0], pixels.to(home[0]), cfg, dtype)
    seq_len = x.shape[1]
    group = LOCAL
    if sp_shard is None:
        xs = [x]

        def attention(qs, ks, vs):  # [m][0] -> [m][0]
            mesh, axis = tp_shard
            return [[o] for o in tp_multi_head_attention([q[0] for q in qs], [k[0] for k in ks], [v[0] for v in vs],
                                                         cfg.num_heads, scale=scale, mesh=mesh, axis=axis,
                                                         plain=plain, differentiable=differentiable)]
    else:
        mesh, axis = sp_shard
        ring = mesh.shape[axis]
        xs = split_tokens(x, home, n=ring, positions=mesh.local_block()[axis])
        kv_lens = chunk_kv_lens(seq_len, ring)
        group = mesh.group(axis)

        def attention(qs, ks, vs):  # [m][i] -> [m][i]
            if tp_shard is None:
                return [ring_attention(qs[0], ks[0], vs[0], cfg.num_heads, scale=scale, kv_lens=kv_lens, mesh=mesh,
                                       axis=axis, plain=plain)]
            return ring_attention(qs, ks, vs, cfg.num_heads, scale=scale, kv_lens=kv_lens, mesh=mesh, axis=axis,
                                  h_axis=tp_shard[1], plain=plain)

    def layer_fn(li, *xs):
        ls = [[p["layers"][li] for p in row] for row in grid]
        hs = [shard_input(i, xs[i], [l["norm1"] for l in ls[i]]) for i in range(n)]
        q, k, v = ([[dense(hs[i][m], ls[i][m][name], dtype) for i in range(n)] for m in range(tp)] for name in "qkv")
        attn = attention(q, k, v)
        out = []
        for i in range(n):
            a = reduce(i, [F.linear(attn[m][i], ls[i][m]["out"]["w"].to(dtype)) for m in range(tp)],
                       ls[i][0]["out"]["b"])
            if cfg.use_layerscale:
                a = a * ls[i][0]["ls1"].to(dtype)
            x = xs[i] + a
            h2 = shard_input(i, x, [l["norm2"] for l in ls[i]])
            g = [gelu(dense(h2[m], ls[i][m]["fc1"], dtype)) for m in range(tp)]
            h = reduce(i, [F.linear(g[m], ls[i][m]["fc2"]["w"].to(dtype)) for m in range(tp)], ls[i][0]["fc2"]["b"])
            if cfg.use_layerscale:
                h = h * ls[i][0]["ls2"].to(dtype)
            out.append(x + h)
        return tuple(out)

    for li in range(len(grid[0][0]["layers"]) - 1):
        xs = _remat(lambda *xs, li=li: layer_fn(li, *xs), remat)(*xs)

    last = [[p["layers"][-1] for p in row] for row in grid]
    if key_fold is not None:
        # the fold is replicated work on the replicated stream: no shard input
        fw, fb = key_fold
        folded = [dense(layer_norm(xs[i], last[i][0]["norm1"], eps), {"w": fw.to(home[i]), "b": fb.to(home[i])},
                        dtype) for i in range(n)]
        folded = gather_tokens(folded, seq_len, home[0], group)
        return {"folded_features": folded[:, 1:].reshape(b, gh, gw, fw.shape[0])}
    hs = [shard_input(i, xs[i], [l["norm1"] for l in last[i]]) for i in range(n)]
    ks = [[dense(hs[i][m], last[i][m]["k"], dtype) for m in range(tp)] for i in range(n)]
    k = gather_tokens([all_gather_tokens(torch.cat([k_m.to(home[i]) for k_m in ks[i]], dim=-1), model_group, dim=-1)
                       for i in range(n)], seq_len, home[0], group)
    out = {"key_tokens": k, "key_features": k[:, 1:].reshape(b, gh, gw, cfg.hidden_size)}
    if want_cls_attention:
        cls = torch.cat([_cls_attention(h, k_m, layer["q"], cfg.num_heads // tp_total, cfg.head_dim, scale,
                                        dtype).to(home[0]) for h, k_m, layer in zip(hs[0], ks[0], last[0])], dim=1)
        out["cls_attention"] = all_gather_tokens(cls, model_group, dim=1)
    return out
