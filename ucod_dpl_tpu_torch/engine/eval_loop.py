"""Stage-1 evaluation with LookTwice zoom-in re-inference, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.engine.eval_loop` (the reference's
``ValLoop_Look_Twice``, ``loop_UCOD_DPL.py:276-417``): decode the cached
features, upsample and binarise; where the largest connected component is
small (< ``look_twice_th``), grow each component's bbox, crop the original
image, run the crops through the backbone again and paste the refined masks
back; score every image with the float64 COD metrics and write its mask.

The host helpers (connected components -> bboxes -> crops -> paste) are
numpy; Pillow is imported only when crops are cut or pasted.  The device
passes run on the runner's device: the first pass is the decoder on the
cached features, the crop pass the folded live path
(``models/dba.py::fg_logits_live``: K1 and K6, eleven launches each per
forward on the card).  All crops of a batch of images go through the
backbone in bucket-padded calls of at most 16.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ucod_dpl_tpu_torch.data.transforms import image_transform
from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear_np
from ucod_dpl_tpu_torch.utils.components import bounding_rect, connected_components
from ucod_dpl_tpu_torch.utils.profiling import annotate

# crop batches are padded to these sizes, as in the JAX package (which
# compiles one program per size)
_CROP_BUCKETS = (4, 16)


def _bucket(n: int) -> int:
    for b in _CROP_BUCKETS:
        if n <= b:
            return b
    return ((n + _CROP_BUCKETS[-1] - 1) // _CROP_BUCKETS[-1]) * _CROP_BUCKETS[-1]


def batched_crop_infer(crops: List[np.ndarray], crop_batch_fn) -> np.ndarray:
    """Run crop arrays through ``crop_batch_fn`` in bucket-padded chunks of at
    most the largest bucket."""
    cap = _CROP_BUCKETS[-1]
    parts = []
    for s0 in range(0, len(crops), cap):
        chunk = crops[s0 : s0 + cap]
        batch = np.zeros((_bucket(len(chunk)), *chunk[0].shape), dtype=np.float32)
        batch[: len(chunk)] = np.stack(chunk)
        parts.append(np.asarray(crop_batch_fn(batch))[: len(chunk)])
    return np.concatenate(parts)


def expand_bbox(
    mask: np.ndarray,
    bbox: Tuple[int, int, int, int],
    img_width: int,
    img_height: int,
    expand_type: str = "const",
    scale: float = 1.3,
) -> List[int]:
    """Grow a component bbox; 'dynamic' scales by sqrt(2 - br/fr)
    (loop_UCOD_DPL.py:399-417), clamped at 0 where the reference would raise."""
    x, y, w, h = bbox
    if expand_type == "dynamic":
        fr = mask[y : y + h, x : x + w].sum() / (h * w)
        br = (h * y) / (mask.shape[-2] * mask.shape[-1])
        scale = math.sqrt(max(1.0 - br / fr + 1.0, 0.0)) if fr > 0 else scale
    new_w = w * scale
    new_h = h * scale
    new_x = max(0.0, x - (new_w - w) / 2)
    if new_x + new_w > img_width:
        new_x = img_width - new_w
    new_y = max(0.0, y - (new_h - h) / 2)
    if new_y + new_h > img_height:
        new_y = img_height - new_h
    return [int(new_x), int(new_y), int(new_w), int(new_h)]


def resize_bbox(bbox, original_width, original_height, new_width, new_height) -> List[int]:
    x, y, w, h = bbox
    ws = new_width / original_width
    hs = new_height / original_height
    return [int(x * ws), int(y * hs), int(w * ws), int(h * hs)]


def find_refine_bboxes(
    binary_hw: np.ndarray, img_size: Tuple[int, int], look_twice_th: float, expand_type: str
) -> Optional[List[List[int]]]:
    """Component analysis -> bboxes to look at again, or None
    (loop_UCOD_DPL.py:354-384).  ``binary_hw``: (H, W) {0, 1}."""
    h, w = img_size
    num, labels = connected_components(binary_hw)
    if num == 0:
        return [[129, 129, 259, 259]]  # the reference's fixed centre box (518px)
    areas = np.bincount(labels.ravel(), minlength=num + 1)[1:] / (h * w)
    if areas.max() >= look_twice_th:
        return None
    bboxes = []
    for i in np.nonzero(areas > 0.01)[0]:
        comp = (labels == i + 1).astype(np.uint8)
        bboxes.append(expand_bbox(comp, bounding_rect(comp), h, w, expand_type=expand_type))
    bboxes.sort(key=lambda b: -b[2] * b[3])
    return bboxes


def prepare_crops(img, bboxes: List[List[int]], img_size: Tuple[int, int]):
    """Drop degenerate boxes, open the image (path or PIL) and cut the
    normalised crop arrays (loop_UCOD_DPL.py:334-342) -> (bboxes, crops)."""
    bboxes = [b for b in bboxes if b[2] > 0 and b[3] > 0]
    if not bboxes:
        return [], []
    if isinstance(img, (str, os.PathLike)):
        from PIL import Image

        img = Image.open(img)
    ih, iw = img_size
    crops = []
    for bbox in bboxes:
        x, y, w, h = resize_bbox(bbox, iw, ih, img.size[0], img.size[1])
        cropped = img.crop((x, y, x + max(w, 1), y + max(h, 1)))
        crops.append(image_transform(cropped.convert("RGB"), img_size))
    return bboxes, crops


def paste_refined(mask_hw: np.ndarray, bboxes: List[List[int]], preds: np.ndarray) -> np.ndarray:
    """Paste the per-crop refined masks back (loop_UCOD_DPL.py:348-352)."""
    from PIL import Image

    new_mask = Image.fromarray((mask_hw * 255).astype(np.uint8))
    for bbox, pred in zip(bboxes, preds):
        pil = Image.fromarray((pred * 255).astype(np.uint8)).resize((bbox[2], bbox[3]))  # bicubic
        new_mask.paste(pil, (bbox[0], bbox[1]))
    return np.asarray(new_mask, dtype=np.float32) / 255.0


def refine_with_crops(img, bboxes, mask_hw: np.ndarray, img_size: Tuple[int, int], crop_batch_fn) -> np.ndarray:
    """Crop, re-infer and paste every bbox; all crops of an image go through
    ``crop_batch_fn`` ((N, H, W, 3) normalised crops -> (N, fh, fw) binary
    masks) in one call."""
    bboxes, crops = prepare_crops(img, bboxes, img_size)
    if not bboxes:
        return mask_hw
    return paste_refined(mask_hw, bboxes, batched_crop_infer(crops, crop_batch_fn))



class LookTwiceEvaluator:
    """One stage-1 evaluation sweep of ``runner.val_dataloader`` on
    ``runner.device``.  After :meth:`run`: ``result`` (the metrics),
    ``crops`` (LookTwice crops re-inferred), ``crop_batches`` (backbone
    forwards they took), ``seconds`` (host clock of the sweep) and
    ``split`` (those seconds by stage: waiting for the loader, the first
    pass, LookTwice's host work, the crop pass, resize + metrics, waiting
    for the mask writes)."""

    def __init__(self, cfg, runner):
        from ucod_dpl_tpu_torch.models.convert import params_to

        self.cfg = cfg
        self.runner = runner
        self.img_size = tuple(cfg.dataset_cfg.valset_cfg.image_size)
        self.feature_size = cfg.model_cfg.feature_size
        self.look_twice_enabled = cfg.val_cfg.get("look_twice", False)
        self.look_twice_th = cfg.val_cfg.get("look_twice_th", 0.15)
        self.expand_type = cfg.val_cfg.get("expand_type", "const")
        self.save_preds = cfg.val_cfg.get("save_preds", True)
        self.fe = runner.feature_extractor
        self.device = self.fe.device
        self.decoder = params_to(runner.decoder_params, self.device)
        # the first pass of the next batch runs on its own stream while the
        # host works on the current one (the crop pass runs on the current stream)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.result = None
        self.crops = 0
        self.crop_batches = 0
        self.seconds = 0.0
        self.split = dict.fromkeys(("loader", "first pass", "LookTwice host", "crop pass", "metrics",
                                    "mask writes"), 0.0)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Time a stage into ``split[name]``; under a profiler, also a span of
        that name (so a ``--profile`` trace names the log line's stages)."""
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            self.split[name] += time.perf_counter() - t0

    # -- device passes ---------------------------------------------------------
    @torch.inference_mode()
    def _dispatch_first_pass(self, features: np.ndarray):
        """Queue the first pass of a (B, fh, fw, C) feature batch: the
        decoder (its 1x1 decoupling before the resize to ``feature_size``),
        bilinear to ``img_size``, sigmoid > 0.5 as uint8 (B, H, W), copied
        into pinned host memory.  Returns (host tensor, event or None); read
        the tensor after ``event.synchronize()``."""
        from ucod_dpl_tpu_torch.models.dba import rev_decoder_forward_resized
        from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear_nhwc

        feats = torch.from_numpy(np.ascontiguousarray(features, np.float32))
        if self._stream is None:
            ctx = contextlib.nullcontext()
        else:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx = torch.cuda.stream(self._stream)
            feats = feats.pin_memory()
        with ctx:
            feats = feats.to(self.device, non_blocking=True)
            fg, _, _ = rev_decoder_forward_resized(self.decoder, feats, self.feature_size)
            up = interpolate_bilinear_nhwc(fg, self.img_size)[..., 0]
            masks = (torch.sigmoid(up) > 0.5).to(torch.uint8)
            if self._stream is None:
                return masks, None
            host = torch.empty(masks.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(masks, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return host, event

    @torch.inference_mode()
    def crop_pass(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) normalised crops -> (N, fh, fw) float32 {0, 1} masks
        at the patch grid, through ``fg_logits_live`` with the key fold."""
        from ucod_dpl_tpu_torch.models.dba import fg_logits_live

        with self._stage("crop pass"):
            pixels = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
            fg, _, _ = fg_logits_live(
                self.fe.params, self.decoder, pixels, self.fe.config, compute_dtype=self.fe.compute_dtype
            )
            self.crop_batches += 1
            return (torch.sigmoid(fg[..., 0]) > 0.5).float().cpu().numpy()

    # -- host helpers ----------------------------------------------------------
    def process_preds(self, binary_hw: np.ndarray) -> Optional[List[List[int]]]:
        return find_refine_bboxes(binary_hw, self.img_size, self.look_twice_th, self.expand_type)

    def look_twice(self, img_path, bboxes: List[List[int]], mask_hw: np.ndarray) -> np.ndarray:
        """One image's LookTwice (the JAX method): cut ``bboxes`` (at
        ``img_size``) from the image at ``img_path``, run the crops through
        :meth:`crop_pass` (bucket-padded calls of at most 16: one for up to
        16 crops) and paste the refined masks into ``mask_hw`` ((H, W)
        {0, 1}) -> the refined (H, W) float32 mask.  :meth:`run` batches
        the crops of a whole batch of images instead."""
        return refine_with_crops(img_path, bboxes, mask_hw, self.img_size, self.crop_pass)

    # -- the sweep -------------------------------------------------------------
    def run(self) -> dict:
        """Batched first pass at any val batch size, LookTwice over all the
        crops of a batch at once, per-image metrics and mask writes.  The
        next batch's first pass is queued before the current batch's host
        work; PNG writes go through a small thread pool; per-image scoring
        fans out to a process pool on large datasets (``metric_workers``:
        -1 = auto)."""
        from ucod_dpl_tpu_torch.engine import preempt
        from ucod_dpl_tpu_torch.utils.fileio import save_binary_mask
        from ucod_dpl_tpu_torch.utils.metrics import CODStatistics
        from ucod_dpl_tpu_torch.utils.progress import ProgressReporter

        t0 = time.perf_counter()
        loader = self.runner.val_dataloader
        n_total = len(loader.dataset)
        workers = self.cfg.val_cfg.get("metric_workers", -1)
        if workers < 0:
            workers = CODStatistics.auto_workers(n_total)
        stats = CODStatistics(workers=workers)
        logger = self.runner.logger
        dataset_name = self.cfg.dataset_cfg.valset_cfg.DATASET
        logger.log(f"start validate on {dataset_name} (metric_workers={workers})")
        progress = ProgressReporter(logger, n_total, f"eval {dataset_name}")
        io_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        io_futures = []
        loader_bs = loader.batch_size

        def dispatch(batch):
            features = np.asarray(batch["features"])  # (B, fh, fw, C)
            n = features.shape[0]
            if n < loader_bs:  # the tail batch padded to the loader's batch, as the JAX loop does
                features = np.concatenate([features, np.repeat(features[-1:], loader_bs - n, axis=0)])
            return self._dispatch_first_pass(features), n

        def process(pending):
            ((host, event), n), batch = pending
            if event is not None:
                with self._stage("first pass"):
                    event.synchronize()
            binaries = [b.astype(np.float32) for b in host.numpy()[:n]]
            if self.look_twice_enabled:
                work = []  # (image index, bboxes, crop arrays)
                with self._stage("LookTwice host"):
                    for i in range(n):
                        bboxes = self.process_preds(binaries[i])
                        if bboxes is None:
                            continue
                        vb, crops = prepare_crops(batch["img_path"][i], bboxes, self.img_size)
                        if vb:
                            work.append((i, vb, crops))
                if work:
                    all_crops = [c for _, _, crops in work for c in crops]
                    self.crops += len(all_crops)
                    preds = batched_crop_infer(all_crops, self.crop_pass)
                    off = 0
                    with self._stage("LookTwice host"):
                        for i, vb, crops in work:
                            binaries[i] = paste_refined(binaries[i], vb, preds[off : off + len(crops)])
                            off += len(crops)
            for binary, label, img_path in zip(binaries, batch["label"], batch["img_path"]):
                lh, lw = label.shape[:2]
                with self._stage("metrics"):
                    pred = (interpolate_bilinear_np(binary, (lh, lw)) > 0.5).astype(np.float64)
                    stats.step(label[None, :, :, 0], pred[None])
                if self.save_preds:
                    out_path = os.path.join(
                        self.cfg.log_cfg.log_path, "preds", dataset_name, os.path.basename(img_path)
                    )
                    io_futures.append(io_pool.submit(save_binary_mask, pred, out_path))
                    if len(io_futures) > 256:  # bound the backlog of queued arrays
                        with self._stage("mask writes"):
                            for fut in io_futures[:128]:
                                fut.result()
                        del io_futures[:128]
            progress.update(n)

        try:
            # cooperative preemption poll between batches (a no-op unless a
            # trainer installed the handler)
            poll = preempt.GlobalPoll(len(loader))
            pending = None
            batches = iter(loader)
            while True:
                with self._stage("loader"):
                    batch = next(batches, None)
                if batch is None:
                    break
                poll.step()
                with self._stage("first pass"):
                    dev = dispatch(batch)
                if pending is not None:
                    process(pending)
                pending = (dev, batch)
            if pending is not None:
                process(pending)
            poll.finish()
            progress.finish()
            with self._stage("mask writes"):
                for fut in io_futures:
                    fut.result()  # raise IO errors here
        except BaseException:
            # error or preemption: drop the queued writes and stop the metric
            # workers, then re-raise
            for fut in io_futures:
                fut.cancel()
            io_pool.shutdown(wait=False, cancel_futures=True)
            stats.close()
            raise
        io_pool.shutdown()
        stats.sync_across_processes()
        with self._stage("metrics"):
            self.result = result = stats.get_result()
        self.seconds = time.perf_counter() - t0
        logger.log(f"LookTwice on {dataset_name}: {self.crops} crops in {self.crop_batches} backbone calls; "
                   + ", ".join(f"{k} {v:.3f} s" for k, v in self.split.items()) + f" of {self.seconds:.3f} s")
        logger.log_table({k: [round(v, 4)] for k, v in result.items()})
        return result
