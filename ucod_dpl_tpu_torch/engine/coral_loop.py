"""CORAL stage-2 loops, jax-free: UDLR evaluation and refiner training.

Counterpart of :mod:`ucod_dpl_tpu.engine.coral_loop`.  The evaluation (the
reference's ``LocalRefineValidationLoop``, ``engine/runner/
loop_CORAL.py:41-341``): multi-resolution features, the optional 2 x 2
m-patch prediction stitch (68px windows at stride 34 on a 102px canvas,
``concate_preds`` at ``loop_CORAL.py:62-96``), the centre-crop fallback when
the coarse foreground share is under 0.1%, the SparseRefiner forward, the
centre pad of a cropped sample, metrics and PNG masks.  The training (the
reference ships only a stub, ``loop_CORAL.py:38-39``; the JAX package's
trainer): the refiner distils toward the frozen stage-1 decoder evaluated on
each window's high-res features, with AdamW at a per-epoch step rate, an EMA
copy, periodic validation and deferred preemption.  The decoder and the
refiner run on the runner's device in float32 (plain PyTorch, as the JAX
package leaves them to XLA); the features come from the caches of
:class:`~ucod_dpl_tpu_torch.data.dataset.LRDataset` or, for the fallback,
from the extractor (on the card through K1 and K6).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ucod_dpl_tpu_torch.engine import preempt
from ucod_dpl_tpu_torch.engine.train_step import Optimizer
from ucod_dpl_tpu_torch.models.convert import params_to, snapshot, tree_leaves, tree_map
from ucod_dpl_tpu_torch.models.dba import rev_decoder_forward
from ucod_dpl_tpu_torch.models.udlr import refiner_train_loss, save_refiner_checkpoint, sparse_refiner_forward
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


def _ema(ema, params, alpha: float):
    """``alpha * ema + (1 - alpha) * params`` leaf by leaf, as the JAX loop writes it."""
    if isinstance(params, torch.Tensor):
        return alpha * ema + (1.0 - alpha) * params.detach()
    return {k: _ema(ema[k], v, alpha) for k, v in params.items()}


def require_one_process() -> None:
    """Refuse stage-2 training when the launcher asks for more than one
    process (``WORLD_SIZE > 1``, the variable that starts the group): the
    stage-2 loaders are per-rank and the refiner's step takes no
    cross-process gradient sum, so ranks would train divergent refiners and
    race on the same checkpoint paths (its whole schedule is minutes of
    device time on one card).  The runner calls it before any cache build."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("stage-2 (CORAL) training is single-process: run it as one process")


class LocalRefineTrainLoop:
    """CORAL stage-2 refiner training on ``runner.device``, step for step the
    JAX package's loop.  Each step: the refiner on the batch's features and
    the coarse prediction (the frozen decoder on the 2 x 2 m-patch stitch
    when the batch has m-patches, else on the l-features), window targets
    ``sigmoid(decoder(window features)) > 0.5`` from the raw decoder under
    ``no_grad``, :func:`~ucod_dpl_tpu_torch.models.udlr.refiner_train_loss`,
    AdamW on the refiner alone.  The rate is set once per epoch to ``lr0 *
    gamma ** (epoch // step_lr_size)`` (optax's ``inject_hyperparams``, not
    stage 1's per-batch StepLR).  The EMA copy follows the refiner until
    ``start_ema`` and then ``alpha = min(1 - 1/(step + 1), ema_weight)``
    with ``step`` counting the steps since.  Validation every
    ``val_interval`` epochs from ``val_start``; the refiner and its EMA are
    saved every epoch.  A preemption signal saves
    ``epoch{N}_preempt.safetensors`` from the current weights and exits
    ``128 + signum``; a restart begins from that refiner with fresh
    optimizer moments, as the JAX package's does.  ``epoch_losses`` holds
    each epoch's mean loss."""

    def __init__(self, cfg, runner):
        self.cfg = cfg
        self.runner = runner
        self.device = runner.device
        tc, mc, vc = cfg.train_cfg, cfg.model_cfg, cfg.val_cfg
        self.max_epoch = tc.max_epoch
        self.window_length = mc.window_length
        self.window_size = mc.get("window_size", 3)
        self.threshold = float(mc.get("threshold", 0.0015))
        self.lr0 = tc.get("lr0", 1e-4)
        self.gamma = tc.get("step_lr_gamma", 0.95)
        self.step_size = tc.get("step_lr_size", 2)
        self.ema_weight = mc.get("ema_weight", 0.70)
        self.start_ema = cfg.get("start_ema", 1)
        self.val_interval = vc.get("val_interval", 4)
        self.val_start = vc.get("val_start", 4)
        self.decoder = params_to(runner.decoder_params, self.device)
        self.trainable = tree_map(lambda t: t.detach().to(self.device, torch.float32).clone().requires_grad_(True),
                                  runner.refiner_params)
        self.optimizer = Optimizer(tree_leaves(self.trainable), self.lr0)
        self.lr = self.lr0
        self.ema_params = None
        self.ema_step = 0  # steps since start_ema
        self.epoch_losses = []

    def set_epoch_lr(self, epoch: int) -> None:
        self.lr = self.lr0 * self.gamma ** (epoch // self.step_size)
        # optax keeps the injected rate as a float32
        self.optimizer.set_lr(float(np.float32(self.lr)))

    def prepare(self, batch):
        """A batch's refiner inputs (l features, h features, coarse
        prediction) on the device."""
        m_input = batch.get("m_inputs")
        if m_input is None or isinstance(m_input, list):
            m_input = None
        with torch.no_grad():
            return prepare_refine_inputs(self.decoder, batch["features"], batch["h_inputs"], m_input,
                                         self.window_length)

    def train_step(self, l_feat: torch.Tensor, h_feat: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
        """One AdamW step of the refiner; returns the loss (on the device)."""
        ws, wl = self.window_size, self.window_length
        out = sparse_refiner_forward(self.trainable, l_feat, h_feat, preds, window_size=ws, threshold=self.threshold)
        with torch.no_grad():
            b, c = l_feat.shape[0], l_feat.shape[-1]
            logits = decoder_fg(self.decoder, h_feat.reshape(b * ws * ws, wl, wl, c))
            h_targets = (torch.sigmoid(logits) > 0.5).float()
        loss = refiner_train_loss(out, preds, h_targets, window_size=ws)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def update_ema(self, epoch: int) -> None:
        with torch.no_grad():
            if epoch >= self.start_ema:
                alpha = min(1.0 - 1.0 / (self.ema_step + 1.0), self.ema_weight)
                self.ema_params = _ema(self.ema_params, self.trainable, alpha)
                self.ema_step += 1
            else:
                self.ema_params = snapshot(self.trainable)

    def _maybe_preempt_exit(self, epoch: int, signum=None) -> None:
        """Save the current refiner and exit if a preemption signal was
        flagged (:func:`preempt.requested_global`, this process's own flag)."""
        signum = signum if signum is not None else preempt.requested_global()
        if signum is None:
            return
        self.runner.refiner_params = snapshot(self.trainable)
        path = self.runner.save_refiner(f"{epoch}_preempt")
        self.runner.logger.log(f"Preemption signal {signum}: refiner saved to {path}; restart stage 2 with "
                               f"--refiner_path {path}")
        raise SystemExit(128 + signum)

    def _run_epoch(self, epoch: int) -> float:
        """The epoch's steps; returns their mean loss."""
        self.set_epoch_lr(epoch)
        losses = []
        self.runner.train_dataloader.set_epoch(epoch)
        for batch in self.runner.train_dataloader:
            losses.append(self.train_step(*self.prepare(batch)))
            self._maybe_preempt_exit(epoch)
            self.update_ema(epoch)
        return float(np.mean(torch.stack(losses).cpu().double().numpy()))

    def run(self) -> None:
        runner = self.runner
        require_one_process()
        preempt.install()
        for epoch in range(self.max_epoch):
            self.epoch_losses.append(self._run_epoch(epoch))
            runner.logger.log(f"[stage2] epoch {epoch}: loss={self.epoch_losses[-1]:.4f} lr={self.lr:.2e}")
            runner.refiner_params = snapshot(self.trainable)
            if (epoch + 1) % self.val_interval == 0 and (epoch + 1) >= self.val_start:
                try:
                    runner.launch_val()
                except preempt.Preempted as e:
                    # validation never changes the refiner: save it and exit now
                    self._maybe_preempt_exit(epoch, e.signum)
            self._save(epoch + 1)
            self._maybe_preempt_exit(epoch)

    def _save(self, epoch: int) -> None:
        path = self.runner.save_refiner(epoch)
        self.runner.logger.log(f"Saved refiner checkpoint {path}")
        if self.ema_params is not None:
            save_refiner_checkpoint(os.path.join(self.runner.log_path, "refiner_ckp", f"epoch{epoch}_ema.safetensors"),
                                    self.ema_params)
