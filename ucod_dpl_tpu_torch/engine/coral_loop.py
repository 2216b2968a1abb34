"""CORAL stage-2 evaluation, jax-free: UDLR local refinement.

Counterpart of the evaluation half of :mod:`ucod_dpl_tpu.engine.coral_loop`
(the reference's ``LocalRefineValidationLoop``, ``engine/runner/
loop_CORAL.py:41-341``): multi-resolution features, the optional 2 x 2
m-patch prediction stitch (68px windows at stride 34 on a 102px canvas,
``concate_preds`` at ``loop_CORAL.py:62-96``), the centre-crop fallback when
the coarse foreground share is under 0.1%, the SparseRefiner forward, the
centre pad of a cropped sample, metrics and PNG masks.  The decoder and
the refiner run on the runner's device in float32 (plain PyTorch, as the
JAX package leaves them to XLA); the features come from the caches of
:class:`~ucod_dpl_tpu_torch.data.dataset.LRDataset` or, for the fallback,
from the extractor (on the card through K1 and K6).  The refiner's
training loop is ROADMAP Queue 1 item 15's training half.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ucod_dpl_tpu_torch.models.convert import params_to
from ucod_dpl_tpu_torch.models.dba import rev_decoder_forward
from ucod_dpl_tpu_torch.models.udlr import sparse_refiner_forward
from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear_nhwc, interpolate_bilinear_np


def concate_m_patch_preds(preds: torch.Tensor) -> torch.Tensor:
    """(B, 4, 68, 68, 1) predictions of the 2 x 2 m-patches -> (B, 102, 102,
    1), overlaps averaged (stride 34), as ``loop_CORAL.concate_preds``."""
    b = preds.shape[0]
    canvas = preds.new_zeros((b, 102, 102, 1))
    counter = preds.new_zeros((b, 102, 102, 1))
    for idx, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y, x = i * 34, j * 34
        canvas[:, y : y + 68, x : x + 68] += preds[:, idx]
        counter[:, y : y + 68, x : x + 68] += 1.0
    return canvas / (counter + 1e-6)


def decoder_fg(decoder_params, feats: torch.Tensor) -> torch.Tensor:
    """The stage-1 decoder's foreground logits (B, h, w, 1) of (B, h, w, C)
    features."""
    fg, _, _ = rev_decoder_forward(decoder_params, feats, with_loss=False)
    return fg


def _make_refine(window_size: int, threshold: float, num_heads: int = 8):
    """refine(params, l_feat, h_feat, preds) -> the refiner's fused logits."""
    def refine(refiner_params, l_feat, h_feat, preds):
        return sparse_refiner_forward(refiner_params, l_feat, h_feat, preds, window_size=window_size,
                                      threshold=threshold, num_heads=num_heads).outputs

    return refine


def prepare_refine_inputs(decoder_params, l_input, h_input, m_input, window_length: int):
    """The refiner's inputs (``loop_CORAL.py:206-245``), shared by the
    evaluator and ``RefinePredictor``: l and h features resized to the
    window length, and the coarse prediction, the stage-1 decoder's on the
    2 x 2 m-patch stitch when m features are given, else on the resized l
    features.  Host arrays or tensors in (``l`` (B, h, w, C), ``h`` (B, ws^2,
    h, w, C), ``m`` (B, 4, h, w, C) or None); tensors on the decoder's
    device out."""
    device = decoder_params.decoupling_w.device

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray) else x,
                               dtype=torch.float32, device=device)

    wl = window_length
    l_input, h_input = tensor(l_input), tensor(h_input)
    b, c = l_input.shape[0], l_input.shape[-1]
    l_feat = interpolate_bilinear_nhwc(l_input, (wl, wl))
    h_feat = interpolate_bilinear_nhwc(h_input.reshape(-1, *h_input.shape[2:]), (wl, wl)).reshape(b, -1, wl, wl, c)
    if m_input is not None:
        m_input = tensor(m_input)
        m_feat = interpolate_bilinear_nhwc(m_input.reshape(-1, *m_input.shape[2:]), (68, 68))
        preds = concate_m_patch_preds(decoder_fg(decoder_params, m_feat).reshape(b, 4, 68, 68, 1))
    else:
        preds = decoder_fg(decoder_params, l_feat)
    return l_feat, h_feat, preds


def center_pad(x: np.ndarray, fill: float = -10.0) -> np.ndarray:
    """(B, H, W, C) -> (B, 2H, 2W, C) with ``x`` in the centre and ``fill``
    around it (``loop_CORAL.py:168-204``)."""
    b, h, w, c = x.shape
    out = np.full((b, 2 * h, 2 * w, c), fill, dtype=x.dtype)
    out[:, h // 2 : h // 2 + h, w // 2 : w // 2 + w] = x
    return out


def refined_probs(out: np.ndarray, size) -> np.ndarray:
    """(H, W, 1) refined output -> (h, w) float32 probabilities at ``size``:
    the output as it is when it lies in [0, 1], else the sigmoid of the
    logits (clipped to +-88, far beyond the 0.5 threshold's reach), then
    bilinear to ``size``."""
    out = out[None]
    in_01 = bool(np.all((out >= 0) & (out <= 1)))
    probs = out if in_01 else 1.0 / (1.0 + np.exp(-np.clip(out, -88.0, 88.0)))
    return interpolate_bilinear_np(np.transpose(probs, (0, 3, 1, 2)), size)[0, 0]


class LocalRefineEvaluator:
    """One CORAL stage-2 evaluation sweep of ``runner.val_dataloader`` on
    ``runner.device``.  After :meth:`run`: ``result``, ``crops`` (samples
    that took the centre-crop fallback), ``seconds`` (host clock of the
    sweep) and ``refine_seconds`` (the host clock of its device passes,
    synchronised)."""

    def __init__(self, cfg, runner):
        self.cfg = cfg
        self.runner = runner
        mc = cfg.model_cfg
        self.window_length = mc.window_length
        self.window_size = mc.get("window_size", 3)
        self.threshold = mc.get("threshold", 0.0015)
        self.require_m = cfg.dataset_cfg.valset_cfg.get("require_m_patches", False)
        self.save_preds = cfg.val_cfg.get("save_preds", True)
        self.device = runner.device
        self.decoder = params_to(runner.decoder_params, self.device)
        self.refiner = params_to(runner.refiner_params, self.device)
        self._refine = _make_refine(self.window_size, float(self.threshold))
        self.result: Optional[Dict[str, float]] = None
        self.crops = 0
        self.seconds = 0.0
        self.refine_seconds = 0.0

    @torch.inference_mode()
    def _refine_host(self, l_input, h_input, m_input):
        """(refined outputs, coarse predictions) as host arrays."""
        t0 = time.perf_counter()
        l_feat, h_feat, preds = prepare_refine_inputs(self.decoder, l_input, h_input,
                                                      m_input if self.require_m else None, self.window_length)
        out = self._refine(self.refiner, l_feat, h_feat, preds).cpu().numpy()
        preds = preds.cpu().numpy()
        self.refine_seconds += time.perf_counter() - t0
        return out, preds

    def _refine_one_cropped(self, img_path: str) -> np.ndarray:
        """The centre-crop fallback of one image: live extraction of its
        centre half, one refiner pass, the centre pad
        (``loop_CORAL.py:148-151, 276-311``)."""
        self.crops += 1
        l_c, h_c, m_c = self.runner.val_dataset.get_features(img_path, crop_center=True)
        out, _ = self._refine_host(l_c, h_c, m_c)
        return center_pad(out)[0]

    def run(self) -> Dict[str, float]:
        """The sweep at the loader's batch size (the reference runs bs 1; the
        tail batch is padded by repeating its last sample, as the JAX loop
        does, which the batch-global maxima of the refiner see), the
        fallback per image, per-image metrics and mask writes."""
        from ucod_dpl_tpu_torch.engine import preempt
        from ucod_dpl_tpu_torch.utils.fileio import save_binary_mask
        from ucod_dpl_tpu_torch.utils.metrics import CODStatistics
        from ucod_dpl_tpu_torch.utils.progress import ProgressReporter

        t0 = time.perf_counter()
        runner = self.runner
        loader = runner.val_dataloader
        n_total = len(loader.dataset)
        workers = self.cfg.val_cfg.get("metric_workers", -1)
        if workers < 0:
            workers = CODStatistics.auto_workers(n_total)
        stats = CODStatistics(workers=workers)
        dataset_name = self.cfg.dataset_cfg.valset_cfg.DATASET
        runner.logger.log(f"start validate on {dataset_name} (UDLR)")
        progress = ProgressReporter(runner.logger, n_total, f"eval {dataset_name}")
        loader_bs = loader.batch_size
        try:
            poll = preempt.GlobalPoll(len(loader))
            for batch in loader:
                poll.step()
                l_input = np.asarray(batch["features"], np.float32)
                h_input = np.asarray(batch["h_inputs"], np.float32)
                m_input = batch.get("m_inputs")
                m_input = None if m_input is None or isinstance(m_input, list) else np.asarray(m_input, np.float32)
                n = l_input.shape[0]
                if n < loader_bs:
                    def pad(x):
                        return np.concatenate([x, np.repeat(x[-1:], loader_bs - n, axis=0)])

                    l_input, h_input = pad(l_input), pad(h_input)
                    m_input = None if m_input is None else pad(m_input)
                outputs, preds = self._refine_host(l_input, h_input, m_input)
                outputs, preds = outputs[:n], preds[:n]
                ratios = (preds > 0).sum(axis=(1, 2, 3)) / (preds.shape[1] * preds.shape[2])
                outs = list(outputs)
                for i in np.nonzero(ratios < 0.001)[0]:
                    outs[i] = self._refine_one_cropped(batch["img_path"][i])
                for i in range(n):
                    label = batch["label"][i]
                    pred = (refined_probs(outs[i], label.shape[:2]) > 0.5).astype(np.float64)
                    stats.step(label[None, :, :, 0], pred[None])
                    if self.save_preds:
                        save_binary_mask(pred, os.path.join(self.cfg.log_cfg.log_path, "preds", dataset_name,
                                                            os.path.basename(batch["img_path"][i])))
                progress.update(n)
            poll.finish()
            progress.finish()
        except BaseException:
            stats.close()  # an error or a preemption: stop the scorer pool
            raise
        stats.sync_across_processes()
        self.result = result = stats.get_result()
        self.seconds = time.perf_counter() - t0
        runner.logger.log(f"UDLR on {dataset_name}: {self.crops} centre-crop fallbacks; device passes "
                          f"{self.refine_seconds:.3f} s of {self.seconds:.3f} s")
        runner.logger.log_table({k: [round(v, 4)] for k, v in result.items()})
        return result
