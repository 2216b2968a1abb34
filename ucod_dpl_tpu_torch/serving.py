"""Batched inference API: load once, predict many.

Counterpart of :class:`ucod_dpl_tpu.serving.Predictor`::

    from ucod_dpl_tpu_torch.serving import Predictor
    p = Predictor.from_config("configs/uscod/UCOD-DPL_dinov2.py",
                              checkpoint="weights/UCOD_DPL_dinov2.safetensors")
    masks = p.predict(["im1.jpg", "im2.jpg"])   # list of (H, W) float masks

It runs on the card, ``device="cuda"``, unless the caller passes
``device="cpu"``; without a card the default raises at construction.

Batches are padded to power-of-two buckets up to ``max_batch``; the JAX
package's jitted programs (probabilities or masks, and the LookTwice crop
pass) are eager methods under ``torch.inference_mode()`` around
:func:`ucod_dpl_tpu_torch.models.dba.fg_logits_live`.  On CUDA the backbone
runs in bf16 through the K1 and K6 kernels; with ``quantize="int8"``
through K1 and the int8 kernels K8, K10 and K9.

:class:`RefinePredictor` is the CORAL stage-2 counterpart (the JAX
package's ``RefinePredictor``): the coarse stage-1 prediction refined by
the UDLR refiner, with the l, grid and m features extracted live.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.data.transforms import image_transform
from ucod_dpl_tpu_torch.models.convert import params_to
from ucod_dpl_tpu_torch.models.dba import RevDecoderParams, fg_logits_live
from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear_nhwc, interpolate_bilinear_np
from ucod_dpl_tpu_torch.utils.profiling import annotate


class Predictor:
    """Load-once, predict-many camouflaged-object segmentation on
    ``feature_extractor.device``."""

    def __init__(
        self,
        feature_extractor: FeatureExtractor,
        decoder_params: RevDecoderParams,
        image_size=(518, 518),
        feature_size: int = 68,
        max_batch: int = 16,
        look_twice_th: float = 0.15,
        expand_type: str = "dynamic",
        quantize: Optional[str] = None,
    ):
        """``quantize="int8"``: the int8 (W8A8) backbone
        (``ops/quant.py``), with the linears the extractor holds, or
        quantized once here from its float32 weights.  An extractor built
        with ``quantize="int8"`` opts the Predictor in."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize is None:
            quantize = feature_extractor.quantize
        self.quantize = quantize
        self._qparams = feature_extractor.int8_params() if quantize == "int8" else None
        self.fe = feature_extractor
        self.device = feature_extractor.device
        self.decoder_params = params_to(decoder_params, self.device)
        self.image_size = tuple(image_size)
        self.feature_size = feature_size
        self.max_batch = max_batch
        self.look_twice_th = look_twice_th
        self.expand_type = expand_type

    @classmethod
    def from_config(
        cls, config_path: str, checkpoint: str, *, device="cuda", max_batch: int = 16, strict: bool = True,
        quantize: Optional[str] = None,
    ) -> "Predictor":
        """``device``: the card by default; ``"cpu"`` runs the plain
        versions of the kernels.  ``strict=True``: missing backbone weights
        raise instead of serving random-init features.
        ``quantize="int8"``: the int8 backbone."""
        from ucod_dpl_tpu_torch.config import load_config
        from ucod_dpl_tpu_torch.models.safetensors_io import load_decoder_checkpoint

        cfg = load_config(config_path)
        fe = FeatureExtractor(cfg.dataset_cfg.feature_extractor_cfg, device=device, strict=strict,
                              quantize=quantize)
        decoder, _ema = load_decoder_checkpoint(checkpoint)
        return cls(
            fe,
            decoder,
            image_size=tuple(cfg.dataset_cfg.valset_cfg.get("image_size", (518, 518))),
            feature_size=cfg.model_cfg.feature_size,
            max_batch=max_batch,
            look_twice_th=cfg.val_cfg.get("look_twice_th", 0.15),
            expand_type=cfg.val_cfg.get("expand_type", "dynamic"),
        )

    def _fg_logits(self, batch: np.ndarray, size: Optional[int]) -> torch.Tensor:
        with annotate("entry.upload", bytes=batch.nbytes):
            pixels = torch.from_numpy(batch).to(self.device)
        fg, _, _ = fg_logits_live(
            self.fe.params, self.decoder_params, pixels, self.fe.config,
            compute_dtype=self.fe.compute_dtype, size=size, quant=self._qparams,
        )
        return fg

    @torch.inference_mode()
    def _first_pass(self, batch: np.ndarray, soft: bool) -> np.ndarray:
        """Probabilities (``soft``) or uint8 {0, 1} masks at image_size."""
        fg = self._fg_logits(batch, self.feature_size)
        with annotate("model.upsample"):
            probs = torch.sigmoid(interpolate_bilinear_nhwc(fg, self.image_size)[..., 0])
            out = probs if soft else (probs > 0.5).to(torch.uint8)
        with annotate("entry.download", bytes=out.nbytes):
            return out.cpu().numpy()

    @torch.inference_mode()
    def _crop_pass(self, batch: np.ndarray) -> np.ndarray:
        # LookTwice second pass: masks at the crop's native patch grid, as
        # the eval loop does (loop_UCOD_DPL.py:343-348)
        masks = (torch.sigmoid(self._fg_logits(batch, None)[..., 0]) > 0.5).float()
        with annotate("entry.download", bytes=masks.nbytes):
            return masks.cpu().numpy()

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)

    def _load(self, item):
        """-> (normalised (H, W, 3) float array, original PIL image or None)."""
        if isinstance(item, str) or hasattr(item, "__fspath__"):
            from ucod_dpl_tpu_torch.utils.fileio import ImageIO

            img = ImageIO.read_image(item, "RGB")
            return image_transform(img, self.image_size), img
        arr = np.asarray(item)
        if arr.ndim == 3 and arr.dtype == np.uint8:  # raw RGB image
            from PIL import Image

            img = Image.fromarray(arr)
            return image_transform(img, self.image_size), img
        return arr, None  # already transformed (H, W, 3) float

    def predict(
        self,
        inputs: Sequence[Union[str, np.ndarray]],
        output_size: Optional[tuple] = None,
        look_twice: bool = False,
        soft: bool = False,
    ) -> List[np.ndarray]:
        """Images (paths, uint8 RGB arrays or pre-normalised arrays) -> (H, W)
        float32 masks at ``output_size`` (default: the model's image_size).

        ``look_twice=True``: small predicted objects trigger the zoom-in
        second pass; needs inputs that carry the original image (paths or
        uint8 arrays).  ``soft=True``: sigmoid probabilities instead of {0, 1}
        masks (not with look_twice, which works on binary masks)."""
        if look_twice and soft:
            raise ValueError("look_twice refines binary masks; soft=True is incompatible")
        # a bare path or a single (H, W, 3) image is one input, not a sequence
        if isinstance(inputs, (str, os.PathLike)):
            inputs = [inputs]
        elif isinstance(inputs, np.ndarray):
            if inputs.ndim == 3:
                inputs = [inputs]
            elif inputs.ndim != 4:
                raise ValueError(f"array input must be (H, W, 3) or (N, H, W, 3); got {inputs.shape}")
        inputs = list(inputs)
        if look_twice:
            from ucod_dpl_tpu_torch.engine.eval_loop import find_refine_bboxes, refine_with_crops

        masks: List[np.ndarray] = []
        with annotate("entry.predict", images=len(inputs)):
            i = 0
            while i < len(inputs):
                # decode per chunk: loading the whole list first would hold every
                # original and normalised array in host memory at once
                take = min(self.max_batch, len(inputs) - i)
                with annotate("entry.load"):
                    loaded = [self._load(x) for x in inputs[i : i + take]]
                originals = [im for _, im in loaded]
                if look_twice and any(im is None for im in originals):
                    raise ValueError("look_twice needs the original image: pass paths or uint8 RGB arrays")
                with annotate("entry.fill"):
                    batch = np.zeros((self._bucket(take), *self.image_size, 3), np.float32)
                    for j, (a, _) in enumerate(loaded):
                        if np.shape(a) != (*self.image_size, 3):
                            raise ValueError(
                                f"input {i + j}: expected a path, a uint8 RGB image, or a pre-normalised "
                                f"{(*self.image_size, 3)} float array; got shape {np.shape(a)}"
                            )
                        batch[j] = a
                first = self._first_pass(batch, soft)
                with annotate("entry.unpack"):
                    chunk = [m.astype(np.float32) for m in first[:take]]
                if look_twice:
                    for k, (mask, img) in enumerate(zip(chunk, originals)):
                        bboxes = find_refine_bboxes(mask, self.image_size, self.look_twice_th, self.expand_type)
                        if bboxes is not None:
                            chunk[k] = refine_with_crops(img, bboxes, mask, self.image_size, self._crop_pass)
                masks.extend(chunk)
                i += take

            if output_size is not None:
                with annotate("entry.unpack"):
                    masks = [interpolate_bilinear_np(m, output_size) for m in masks]
                    if not soft:
                        masks = [(m > 0.5).astype(np.float32) for m in masks]
        return masks


class RefinePredictor:
    """Load-once CORAL stage-2 serving on ``feature_extractor.device``: the
    coarse stage-1 prediction and the UDLR local refinement (the
    composition of the reference's ``LocalRefineValidationLoop``,
    ``loop_CORAL.py:41-341``, without dataset, caches or metrics).

    Inputs carry original pixels (paths or uint8 RGB arrays): each call
    extracts the l features at ``image_size``, the 3 x 3 grid patches and,
    with ``use_m_patches``, the 756px m-patches (L 2917 tokens), each
    resolution in one extractor call per chunk of ``max_batch`` images.  A
    chunk is padded to ``max_batch`` by repeating its last image, as the
    JAX package does: the refiner's batch-global maxima see the padding."""

    def __init__(
        self,
        feature_extractor: FeatureExtractor,
        decoder_params: RevDecoderParams,
        refiner_params,
        image_size=(518, 518),
        window_size: int = 3,
        window_length: int = 56,
        threshold: float = 0.0015,
        use_m_patches: bool = True,
        max_batch: int = 4,
        crop_center_ratio: float = 0.001,
    ):
        from ucod_dpl_tpu_torch.engine.coral_loop import _make_refine

        self.fe = feature_extractor
        self.device = feature_extractor.device
        self.decoder_params = params_to(decoder_params, self.device)
        self.refiner_params = params_to(refiner_params, self.device)
        self.image_size = tuple(image_size)
        self.window_size = window_size
        self.window_length = window_length
        self.use_m_patches = use_m_patches
        self.max_batch = max_batch
        self.crop_center_ratio = crop_center_ratio
        self._refine = _make_refine(window_size, float(threshold))

    @classmethod
    def from_config(
        cls,
        config_path: str,
        checkpoint: str,
        refiner_path: str,
        *,
        device="cuda",
        max_batch: int = 4,
        strict: bool = True,
        quantize: Optional[str] = None,
    ) -> "RefinePredictor":
        """``device``: the card by default; ``"cpu"`` runs the plain
        versions of the kernels.  ``quantize="int8"``: the int8 backbone for
        all three resolutions (on the card K8, K1, K10 and K9 per layer)."""
        from ucod_dpl_tpu_torch.config import load_config
        from ucod_dpl_tpu_torch.models.safetensors_io import load_decoder_checkpoint
        from ucod_dpl_tpu_torch.models.udlr import load_refiner_checkpoint

        cfg = load_config(config_path)
        fe = FeatureExtractor(cfg.dataset_cfg.feature_extractor_cfg, device=device, strict=strict,
                              quantize=quantize)
        decoder, _ema = load_decoder_checkpoint(checkpoint)
        mc = cfg.model_cfg
        return cls(
            fe,
            decoder,
            load_refiner_checkpoint(refiner_path),
            image_size=tuple(cfg.dataset_cfg.valset_cfg.get("image_size", (518, 518))),
            window_size=mc.get("window_size", 3),
            window_length=mc.window_length,
            threshold=mc.get("threshold", 0.0015),
            use_m_patches=cfg.dataset_cfg.valset_cfg.get("require_m_patches", True),
            max_batch=max_batch,
        )

    @staticmethod
    def _load_image(item):
        if isinstance(item, str) or hasattr(item, "__fspath__"):
            from ucod_dpl_tpu_torch.utils.fileio import ImageIO

            return ImageIO.read_image(item, "RGB")
        arr = np.asarray(item)
        if arr.ndim == 3 and arr.dtype == np.uint8:
            from PIL import Image

            return Image.fromarray(arr).convert("RGB")
        raise ValueError("RefinePredictor needs original pixels (paths or uint8 RGB arrays) to extract "
                         f"multi-resolution features; got {type(item)!r}"
                         + (f" with shape {arr.shape}/{arr.dtype}" if isinstance(arr, np.ndarray) else ""))

    def _extract(self, imgs):
        """PIL images -> host (l, h, m) features, each resolution in one
        extractor call."""
        from ucod_dpl_tpu_torch.data.dataset import fe_image_size, grid_patch_arrays, slice_m_windows

        l = self.fe.extract(np.stack([image_transform(im, self.image_size) for im in imgs]))
        grids = np.concatenate([grid_patch_arrays(im, self.image_size, self.window_size) for im in imgs])
        gf = self.fe.extract(grids)
        h = gf.reshape(len(imgs), self.window_size ** 2, *gf.shape[1:])
        m = None
        if self.use_m_patches:
            keys = self.fe.extract(np.stack([image_transform(im, fe_image_size(self.fe.fe_cfg.type)) for im in imgs]))
            m = np.stack([slice_m_windows(k) for k in keys])
        return l, h, m

    @torch.inference_mode()
    def _refine_batch(self, l, h, m):
        from ucod_dpl_tpu_torch.engine.coral_loop import prepare_refine_inputs

        l_feat, h_feat, preds = prepare_refine_inputs(self.decoder_params, l, h, m, self.window_length)
        out = self._refine(self.refiner_params, l_feat, h_feat, preds)
        return out.cpu().numpy(), preds.cpu().numpy()

    def _refine_cropped(self, img) -> np.ndarray:
        """The centre-crop fallback for a near-empty coarse prediction
        (``loop_CORAL.py:148-151, 276-311``): the centre half extracted and
        refined alone, then centre-padded with the reference's -10."""
        from ucod_dpl_tpu_torch.engine.coral_loop import center_pad

        w, ht = img.size
        cropped = img.crop((w // 4, ht // 4, w // 4 + w // 2, ht // 4 + ht // 2))
        out, _ = self._refine_batch(*self._extract([cropped]))
        return center_pad(out)[0]

    def predict(
        self,
        inputs: Sequence[Union[str, np.ndarray]],
        output_size: Optional[tuple] = None,
        soft: bool = False,
    ) -> List[np.ndarray]:
        """Images -> (H, W) float32 refined masks ({0, 1}; ``soft=True`` for
        probabilities) at ``output_size`` (default: the model's image
        size)."""
        from ucod_dpl_tpu_torch.engine.coral_loop import refined_probs

        if isinstance(inputs, (str, os.PathLike)):
            inputs = [inputs]
        elif isinstance(inputs, np.ndarray) and inputs.ndim == 3:
            inputs = [inputs]
        inputs = list(inputs)
        size = tuple(output_size) if output_size is not None else self.image_size
        masks: List[np.ndarray] = []
        i = 0
        while i < len(inputs):
            take = min(self.max_batch, len(inputs) - i)
            imgs = [self._load_image(x) for x in inputs[i : i + take]]
            outputs, preds = self._refine_batch(*self._extract(imgs + [imgs[-1]] * (self.max_batch - take)))
            outputs, preds = outputs[:take], preds[:take]
            ratios = (preds > 0).sum(axis=(1, 2, 3)) / (preds.shape[1] * preds.shape[2])
            outs = list(outputs)
            for k in np.nonzero(ratios < self.crop_center_ratio)[0]:
                outs[k] = self._refine_cropped(imgs[k])
            for out in outs:
                up = refined_probs(out, size)
                masks.append(up.astype(np.float32) if soft else (up > 0.5).astype(np.float32))
            i += take
        return masks
