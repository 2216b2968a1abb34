"""DINO feature extraction on a chosen torch device.

Counterpart of :mod:`ucod_dpl_tpu.data.feature_extractor` (the reference's
``data/utils/feature_extractor.py:31-59`` backbone wrapper): local weight
discovery, strict loading, a compute dtype chosen by device (bf16 on CUDA,
float32 on the CPU), and host float32 key features that are checked for
non-finite values.  With a device mesh (``parallel.mesh.build_mesh``) the
batch is split over its ``data`` axis; when its ``model`` axis is > 1 the
backbone runs tensor-parallel (``parallel/tp.py``), when its ``seq`` axis is
> 1 sequence-parallel (``parallel/sp.py``), and with both 2D.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ucod_dpl_tpu_torch.models.convert import params_to
from ucod_dpl_tpu_torch.models.dino import (
    DinoConfig,
    cast_params,
    dino_forward,
    init_dino,
    load_hf_checkpoint,
)
from ucod_dpl_tpu_torch.ops.quant import quantize_dino_linears
from ucod_dpl_tpu_torch.parallel.mesh import data_sharding
from ucod_dpl_tpu_torch.parallel.sp import sp_param_grid
from ucod_dpl_tpu_torch.parallel.tp import shard_dino_params
from ucod_dpl_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

_DTYPE_BY_DEVICE = {"cuda": torch.bfloat16, "cpu": torch.float32}


def _candidate_weight_paths(fe_cfg) -> list:
    """Weight search order mirroring the reference's local->cache fallback
    (``feature_extractor.py:15-29``)."""
    name = fe_cfg.backbone.split("/")[-1]
    cands = []
    for base in (fe_cfg.get("backbone_weights"), fe_cfg.get("backbone_weight_base")):
        if not base:
            continue
        base = Path(os.path.expanduser(base))
        cands += [base, base / name, base / fe_cfg.backbone.replace("/", "--")]
    return cands


class FeatureExtractor:
    """Frozen DINO backbone exposing the key-feature hook contract."""

    def __init__(
        self,
        fe_cfg,
        *,
        device=None,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        strict: Optional[bool] = None,
        qkv_masters: bool = False,
        quantize: Optional[str] = None,
        mesh=None,
    ):
        """``device``: where the backbone runs; it defaults to the first
        device of ``mesh``, and without a mesh to the card,
        ``torch.device("cuda")``.  A CUDA device on a machine without one
        raises here; nothing falls back to the CPU, which a caller asks for
        with ``device="cpu"``.  ``compute_dtype``
        defaults to bf16 on CUDA and float32 on the CPU; ``params`` are held
        cast to it once
        (:func:`~ucod_dpl_tpu_torch.models.dino.cast_params`), except the
        q/k/v weights when ``qkv_masters`` is set: LoRA training keeps those
        as float32 masters and merges its adapters into them at every step.
        ``strict`` (or ``fe_cfg.strict_weights``): missing pretrained
        weights raise instead of falling back to a random initialisation
        from ``seed``.  ``quantize="int8"``: ``extract`` runs the int8 (W8A8)
        backbone, whose linears are quantized once, from the float32
        weights before the cast, into ``_qparams`` (inference only, so not
        with ``qkv_masters``).

        ``mesh``: a device mesh (``tpu_cfg.mesh = {"data": N, "model": M,
        "seq": S}`` in the JAX package).  ``extract`` splits the batch over
        its ``data`` axis (or, when the batch does not divide it, runs it
        whole on the first ``data`` coordinate); when ``model`` > 1 the
        backbone runs tensor-parallel, with the params sharded
        Megatron-style into ``_mesh_params``; when ``seq`` > 1 each data
        coordinate's slice runs sequence-parallel over its ``seq`` devices
        (ring attention; ``_mesh_params`` holds the params per chunk
        device, :func:`~ucod_dpl_tpu_torch.parallel.sp.sp_param_grid`), and
        with both 2D.  ``extract_with_attention`` runs without the ``seq``
        split, as in JAX (the pseudo-label parity contract).  Raises for
        heads that ``model`` does not divide, for ``quantize`` with tensor
        or sequence parallelism, and for either when ``torch.distributed``
        runs more than one process (NotImplementedError: extraction is
        per-process work)."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize is not None and qkv_masters:
            raise ValueError("the int8 path is inference-only; qkv_masters (LoRA training) needs quantize=None")
        self.fe_cfg = fe_cfg
        self.strict = fe_cfg.get("strict_weights", False) if strict is None else strict
        self.config = DinoConfig.from_type(fe_cfg.type)
        arch = fe_cfg.get("arch")  # architecture overrides (tests, small runs)
        if arch:
            self.config = dataclasses.replace(self.config, **dict(arch))
        self.mesh = mesh
        self.tp_shard = None
        self.sp_shard = None
        if mesh is not None:
            processes = torch.distributed.get_world_size() if torch.distributed.is_available() \
                and torch.distributed.is_initialized() else 1
            if mesh.spans_processes:
                raise NotImplementedError(
                    f"feature extraction requires a single-process mesh; {mesh} spans processes (build the mesh "
                    "of this process's cards with build_mesh(cfg, devices=...))")
            if mesh.shape.get("model", 1) > 1:
                if processes > 1:
                    raise NotImplementedError(
                        "tensor-parallel feature extraction requires a single-process mesh (TP over the "
                        "cards of one host); use data parallelism across processes")
                if self.config.num_heads % mesh.shape["model"]:
                    raise ValueError(f"{self.config.num_heads} attention heads not divisible by mesh "
                                     f"model={mesh.shape['model']}")
                if quantize is not None:
                    raise ValueError("the int8 path is single-device; tensor parallelism shards the weights")
                self.tp_shard = (mesh, "model")
            if mesh.shape.get("seq", 1) > 1:
                if processes > 1:
                    # extraction is per-process work, as in the JAX extractor; the ring
                    # crosses processes only in the LoRA train step
                    raise NotImplementedError(
                        "sequence-parallel feature extraction requires a single-process mesh (SP over the cards of "
                        "one host); use data parallelism across processes.  Sequence parallelism across processes "
                        "runs in make_lora_train_step(sp_shard=) on a mesh over processes, as in the JAX package")
                if quantize is not None:
                    raise ValueError("int8 path is single-chip (SP shards the token dim)")
                self.sp_shard = (mesh, "seq")
            if device is None:
                device = mesh.devices.flat[0]
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"FeatureExtractor: device {self.device} requested (the default without a mesh), "
                               "but CUDA is not available; pass device='cpu' to run on the CPU")
        if compute_dtype is None:
            if self.device.type not in _DTYPE_BY_DEVICE:
                raise ValueError(f"no default compute dtype for device {self.device}")
            compute_dtype = _DTYPE_BY_DEVICE[self.device.type]
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.quantize = quantize
        masters = params_to(self._load_params(seed), self.device)
        # quantized from the float32 weights: a bf16 copy gives other codes and scales
        self._qparams = quantize_dino_linears(masters) if quantize == "int8" else None
        self.params = cast_params(masters, compute_dtype, qkv_masters)
        # per data coordinate: a params dict, the list of its model shards, or
        # (sequence parallel) the rows of each chunk's device
        self._mesh_params = None
        if self.sp_shard is not None:
            self._mesh_params = [sp_param_grid(self.params, mesh, "seq", self.tp_shard and "model", data=d)
                                 for d in range(mesh.shape.get("data", 1))]
        elif self.tp_shard is not None:
            self._mesh_params = shard_dino_params(self.params, mesh)
        elif mesh is not None:
            data = range(mesh.shape["data"]) if "data" in mesh.shape else [None]
            self._mesh_params = [params_to(self.params, mesh.device(**({} if d is None else {"data": d})))
                                 for d in data]

    def int8_params(self):
        """The backbone's int8 linears: those it holds (``quantize="int8"``),
        else quantized now from its float32 weights."""
        if self._qparams is not None:
            return self._qparams
        return quantize_dino_linears(self.float32_params())

    def float32_params(self):
        """The backbone's float32 weights on its device: those it holds when
        it computes in float32, else loaded again from the same source (the
        held ones are cast)."""
        if self.compute_dtype == torch.float32:
            return self.params
        return params_to(self._load_params(self.seed), self.device)

    def _load_params(self, seed: int):
        for cand in _candidate_weight_paths(self.fe_cfg):
            if cand.is_file() or (
                cand.is_dir()
                and ((cand / "model.safetensors").exists() or (cand / "pytorch_model.bin").exists())
            ):
                logger.info("Loading DINO weights from %s", cand)
                return load_hf_checkpoint(str(cand), self.config)
        msg = (
            f"No local weights found for {self.fe_cfg.backbone} "
            f"(searched {_candidate_weight_paths(self.fe_cfg)})"
        )
        if self.strict:
            raise FileNotFoundError(
                msg + "; strict weight loading is enabled (serving/eval refuses "
                "to run on random-init features)."
            )
        logger.warning(msg + "; using RANDOM initialisation — features will not match pretrained DINO.")
        return init_dino(seed, self.config)

    @staticmethod
    def _to_host_f32(t: torch.Tensor, what: str) -> np.ndarray:
        """Device tensor -> host float32, raising on non-finite values (a
        non-finite forward evaluates silently as all-background masks)."""
        with annotate("entry.download", bytes=t.numel() * 4):
            arr = t.float().cpu().numpy()
        with annotate("entry.check"):
            finite = np.isfinite(arr).all()
        if not finite:
            raise FloatingPointError(
                f"DINO forward produced non-finite {what} "
                f"({(~np.isfinite(arr)).sum()}/{arr.size} bad) on {t.device} — "
                "kernel or numerics regression."
            )
        return arr

    def _forwards(self, images_nhwc: np.ndarray, sequence_parallel: bool = True, **kw):
        """``dino_forward`` of ``images_nhwc`` on each ``data`` coordinate of
        the mesh (the whole batch on the extractor's device without one),
        every coordinate launched before any result is read, so that their
        devices run side by side.  A batch the data axis does not divide
        runs once (replicated, every coordinate would compute the same).
        ``sequence_parallel=False`` runs a ``seq`` mesh's coordinates on
        their first chunk's device (or model shards) alone."""
        images = np.asarray(images_nhwc, np.float32)
        sp_shard = self.sp_shard if sequence_parallel else None
        if self.mesh is None:
            parts = [(self.params, slice(None))]
        else:
            slices = data_sharding(self.mesh, images.shape[0])
            if slices[0] == slice(None):
                slices = slices[:1]
            parts = []
            for d, sl in enumerate(slices):
                params = self._mesh_params[d]
                if self.sp_shard is not None and sp_shard is None:
                    params = params[0] if self.tp_shard else params[0][0]
                parts.append((params, sl))
        outs = []
        for params, sl in parts:
            first = params
            while not isinstance(first, dict):
                first = first[0]
            with annotate("entry.upload", bytes=images[sl].nbytes):
                pixels = torch.from_numpy(images[sl]).to(first["pos_embed"].device)
            outs.append(dino_forward(params, pixels, self.config, compute_dtype=self.compute_dtype,
                                     tp_shard=self.tp_shard, sp_shard=sp_shard, **kw))
        return outs

    def extract(self, images_nhwc: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) normalised images -> (B, h, w, hidden) float32 key
        features on the host, over the mesh's ``data`` coordinates when there
        is a mesh."""
        with annotate("entry.extract", images=len(images_nhwc)), torch.inference_mode():
            outs = self._forwards(images_nhwc, quant=self._qparams)
            features = [self._to_host_f32(o["key_features"], "features") for o in outs]
            with annotate("entry.concat"):
                return np.concatenate(features)

    def extract_with_attention(self, images_nhwc: np.ndarray):
        """(B, H, W, 3) normalised images -> host float32 ``(key_tokens (B,
        1+N, C), key_features (B, h, w, C), cls_attention (B, heads, 1+N))``,
        the pseudo-label generator's inputs, on the extractor's device or over
        its mesh (under tensor parallelism each shard computes its heads'
        rows; a ``seq`` axis is not used: the parity contract runs
        unsharded, as in JAX).  Always the full-precision forward: an int8 extractor passes
        no int8 linears (the CLS attention is a parity surface).  Tokens and
        attention are checked for non-finite values (NaN probabilities would
        threshold into silently degenerate masks)."""
        with torch.inference_mode():
            outs = self._forwards(images_nhwc, sequence_parallel=False, want_cls_attention=True)
            return (np.concatenate([self._to_host_f32(o["key_tokens"], "key tokens") for o in outs]),
                    np.concatenate([o["key_features"].float().cpu().numpy() for o in outs]),
                    np.concatenate([self._to_host_f32(o["cls_attention"], "CLS attention") for o in outs]))
