"""Streaming COD segmentation metrics (host-side NumPy, float64), jax-free.

The port's copy of the NumPy path of :mod:`ucod_dpl_tpu.utils.metrics`,
which matches the reference metric suite (``engine/utils/metrics/metric.py``
of Heartfirey/UCOD-DPL, after PySODMetrics): MAE, S-measure (Fan et al.),
E-measure (adaptive and a 256-threshold curve), F-measure (beta = 0.3,
adaptive and curve), weighted F-measure (Margolin et al.), pixel accuracy
and mIoU.  The JAX package's native scorer (``native/metrics_kernel.cpp``)
is not carried over: every image is scored here in NumPy.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
from scipy.ndimage import convolve, distance_transform_edt

EPS = np.spacing(1)


def normalize_pair(pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Protocol normalisation: gt -> bool via min-max + 0.5 threshold, pred ->
    min-max to [0,1] (or int-cast when constant).  Mirrors ``_prepare_data``
    (metric.py:125-133)."""
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    if gt.max() != gt.min():
        gt = (gt - gt.min()) / (gt.max() - gt.min())
    gt = gt > 0.5
    if pred.max() != pred.min():
        pred = (pred - pred.min()) / (pred.max() - pred.min())
    else:
        # protocol quirk kept for parity: constant predictions stay integer,
        # which makes the WFM convolution run in integer arithmetic.
        pred = pred.astype(np.int64)
    return pred, gt


def adaptive_threshold(x: np.ndarray, max_value: float = 1.0) -> float:
    return min(2.0 * float(x.mean()), max_value)


# --------------------------------------------------------------------------
# individual metrics (each takes a normalised (pred: float[0,1], gt: bool))
# --------------------------------------------------------------------------

def mae(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - gt)))


def pixel_accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sum(pred == gt) / gt.size)


def binary_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0 if inter == 0 else 0.0
    return float(inter / union)


def _ssim_block(pred: np.ndarray, gt: np.ndarray) -> float:
    n = pred.size
    with np.errstate(invalid="ignore", divide="ignore"):
        mx, my = pred.mean(), gt.mean()
        vx = np.sum((pred - mx) ** 2) / (n - 1)
        vy = np.sum((gt - my) ** 2) / (n - 1)
        cxy = np.sum((pred - mx) * (gt - my)) / (n - 1)
        num = 4.0 * mx * my * cxy
        den = (mx * mx + my * my) * (vx + vy)
    if num != 0:
        return float(num / (den + EPS))
    return 1.0 if den == 0 else 0.0


def _s_object_term(values: np.ndarray) -> float:
    """2x/(x^2+1+sigma) over foreground-restricted values."""
    x = values.mean() if values.size else np.nan
    sx = values.std(ddof=1) if values.size else np.nan
    return float(2.0 * x / (x * x + 1.0 + sx + EPS))


def s_measure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    """Structure measure (object-aware + region-aware SSIM)."""
    y = gt.mean()
    if y == 0:
        return float(1.0 - pred.mean())
    if y == 1:
        return float(pred.mean())

    # object term
    fg = pred * gt
    bg = (1.0 - pred) * (1.0 - gt)
    obj = y * _s_object_term(fg[gt == 1]) + (1.0 - y) * _s_object_term(bg[gt == 0])

    # region term: split at the (1-indexed, rounded) gt centroid
    h, w = gt.shape
    if np.count_nonzero(gt) == 0:
        cx, cy = int(np.round(w / 2)) + 1, int(np.round(h / 2)) + 1
    else:
        yy, xx = np.argwhere(gt).mean(axis=0).round()
        cx, cy = int(xx) + 1, int(yy) + 1
    area = h * w
    quads = [
        (slice(0, cy), slice(0, cx), cx * cy / area),
        (slice(0, cy), slice(cx, w), cy * (w - cx) / area),
        (slice(cy, h), slice(0, cx), (h - cy) * cx / area),
    ]
    region = 0.0
    wsum = 0.0
    for rs, cs, wt in quads:
        region += wt * _ssim_block(pred[rs, cs], gt[rs, cs].astype(np.float64))
        wsum += wt
    region += (1.0 - wsum) * _ssim_block(pred[cy:h, cx:w], gt[cy:h, cx:w].astype(np.float64))

    sm = alpha * obj + (1.0 - alpha) * region
    return float(max(0.0, sm))


def _enhanced_alignment_sum(fg_fg, fg_bg, gt_fg_numel: int, gt_size: int):
    """Vectorised E-measure core: given counts of predicted-fg pixels that are
    gt-fg (``fg_fg``) and gt-bg (``fg_bg``) — scalars or length-T arrays —
    return the summed enhanced alignment matrix."""
    fg_fg = np.asarray(fg_fg, dtype=np.float64)
    fg_bg = np.asarray(fg_bg, dtype=np.float64)
    pred_fg = fg_fg + fg_bg
    pred_bg = gt_size - pred_fg
    if gt_fg_numel == 0:
        return pred_bg
    if gt_fg_numel == gt_size:
        return pred_fg

    bg_fg = gt_fg_numel - fg_fg
    bg_bg = pred_bg - bg_fg
    mean_pred = pred_fg / gt_size
    mean_gt = gt_fg_numel / gt_size

    parts = (fg_fg, fg_bg, bg_fg, bg_bg)
    combos = (
        (1.0 - mean_pred, 1.0 - mean_gt),
        (1.0 - mean_pred, 0.0 - mean_gt),
        (0.0 - mean_pred, 1.0 - mean_gt),
        (0.0 - mean_pred, 0.0 - mean_gt),
    )
    total = np.zeros_like(pred_fg)
    for numel, (a, b) in zip(parts, combos):
        align = 2.0 * a * b / (a * a + b * b + EPS)
        total = total + ((align + 1.0) ** 2 / 4.0) * numel
    return total


def _threshold_histograms(pred: np.ndarray, gt: np.ndarray):
    """Counts of pred>=t pixels inside / outside gt for t over 256 levels.

    pred is quantised to uint8 levels; thresholds sweep high->low via a
    reversed cumulative histogram, matching the reference curve protocol."""
    pred_u8 = (pred * 255).astype(np.uint8)
    bins = np.linspace(0, 256, 257)
    fg_hist, _ = np.histogram(pred_u8[gt], bins=bins)
    bg_hist, _ = np.histogram(pred_u8[~gt], bins=bins)
    fg_cum = np.cumsum(fg_hist[::-1])
    bg_cum = np.cumsum(bg_hist[::-1])
    return fg_cum, bg_cum


def e_measure(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, np.ndarray]:
    """Return (adaptive E, 256-threshold E curve)."""
    gt_fg = int(np.count_nonzero(gt))
    gt_size = gt.size

    thr = adaptive_threshold(pred, 1.0)
    binarized = pred >= thr
    fg_fg = int(np.count_nonzero(binarized & gt))
    fg_bg = int(np.count_nonzero(binarized & ~gt))
    adp = float(_enhanced_alignment_sum(fg_fg, fg_bg, gt_fg, gt_size) / (gt_size - 1 + EPS))

    fg_cum, bg_cum = _threshold_histograms(pred, gt)
    curve = _enhanced_alignment_sum(fg_cum, bg_cum, gt_fg, gt_size) / (gt_size - 1 + EPS)
    return adp, np.asarray(curve, dtype=np.float64)


def f_measure(pred: np.ndarray, gt: np.ndarray, beta: float = 0.3):
    """Return (adaptive F, 256-threshold F curve, precision curve, recall curve)."""
    thr = adaptive_threshold(pred, 1.0)
    binarized = pred >= thr
    inter = binarized[gt].sum()
    if inter == 0:
        adp = 0.0
    else:
        pre = inter / np.count_nonzero(binarized)
        rec = inter / np.count_nonzero(gt)
        adp = float((1 + beta) * pre * rec / (beta * pre + rec))

    fg_cum, bg_cum = _threshold_histograms(pred, gt)
    tps = fg_cum.astype(np.float64)
    ps = (fg_cum + bg_cum).astype(np.float64)
    ps[ps == 0] = 1.0
    t = max(np.count_nonzero(gt), 1)
    precision = tps / ps
    recall = tps / t
    numerator = (1 + beta) * precision * recall
    denominator = np.where(numerator == 0, 1.0, beta * precision + recall)
    curve = numerator / denominator
    return adp, curve, precision, recall


def _gauss_kernel_matlab(shape=(7, 7), sigma: float = 5.0) -> np.ndarray:
    m, n = [(s - 1) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    k[k < np.finfo(k.dtype).eps * k.max()] = 0
    s = k.sum()
    if s != 0:
        k /= s
    return k


def weighted_f_measure(pred: np.ndarray, gt: np.ndarray, beta: float = 1.0) -> float:
    """Weighted F-beta (Margolin et al., 'How to Evaluate Foreground Maps')."""
    if not gt.any():
        return 0.0
    dst, idx = distance_transform_edt(~gt, return_indices=True)
    err = np.abs(pred - gt)
    err_t = err.copy()
    bg = ~gt
    err_t[bg] = err_t[idx[0][bg], idx[1][bg]]
    blurred = convolve(err_t, weights=_gauss_kernel_matlab(), mode="constant", cval=0)
    min_err = np.where(gt & (blurred < err), blurred, err)
    importance = np.where(bg, 2.0 - np.exp(np.log(0.5) / 5.0 * dst), 1.0)
    ew = min_err * importance
    tpw = np.sum(gt) - np.sum(ew[gt])
    fpw = np.sum(ew[bg])
    recall = 1.0 - np.mean(ew[gt])
    precision = tpw / (tpw + fpw + EPS)
    return float((1 + beta) * recall * precision / (recall + beta * precision + EPS))


def _score_one(args) -> tuple:
    """Per-image metric bundle of a (gt, pred) pair (module level, so a
    process pool can pickle it)."""
    g, p = args
    pn, gn = normalize_pair(p, g)
    _, e_curve = e_measure(pn, gn)
    _, f_curve, _, _ = f_measure(pn, gn)
    return (
        s_measure(pn, gn),
        mae(pn, gn),
        weighted_f_measure(pn, gn),
        pixel_accuracy(pn, gn),
        binary_iou(pn, gn),
        e_curve,
        f_curve,
    )


class CODStatistics:
    """Streaming per-image accumulator producing the reference result dict
    keys {ACC, mIOU, E_MAX, E_MEAN, F_MAX, F_MEAN, SMeasure, MAE, WFM}.

    With ``workers > 0``, per-image scoring fans out to a process pool —
    the host-side metrics (distance transforms, 256-threshold curves) are
    otherwise the eval-pipeline bottleneck once the device sustains
    hundreds of images/sec.  Results are order-preserving and identical to
    the synchronous path."""

    def __init__(self, workers: int = 0):
        self.workers = workers
        self._pool = None
        self._pending = []
        self.reset()

    def reset(self) -> None:
        self._sm = []
        self._mae = []
        self._wfm = []
        self._acc = []
        self._iou = []
        self._e_curves = []
        self._f_curves = []
        self._pending = []

    def _ensure_pool(self):
        if self._pool is None:
            import concurrent.futures
            import multiprocessing

            # spawn, not fork: the host process runs torch's threads, and
            # forking a multithreaded process can deadlock
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=multiprocessing.get_context("spawn"),
            )
        return self._pool

    @staticmethod
    def auto_workers(n_total: int) -> int:
        """Shared metric_workers=-1 heuristic (eval + CORAL loops): the
        process pool pays off only on multi-minute sweeps."""
        return (os.cpu_count() or 2) // 2 if n_total >= 64 else 0

    def step(self, gt: np.ndarray, pred: np.ndarray) -> None:
        """Accumulate one batch. Accepts (B,H,W), (B,1,H,W), or (H,W)."""
        gt = np.asarray(gt, dtype=np.float64)
        pred = np.asarray(pred, dtype=np.float64)
        if gt.ndim == 2:
            gt, pred = gt[None], pred[None]
        for g, p in zip(gt, pred):
            g = np.squeeze(g)
            p = np.squeeze(p)
            if self.workers > 0:
                self._pending.append(self._ensure_pool().submit(_score_one, (g, p)))
                # backpressure: each queued item pins two full-res float64
                # arrays (~10MB for a 700x900 pair); the device can outrun
                # the scorers by orders of magnitude, so an unbounded queue
                # would grow to GBs on a multi-thousand-image sweep.  Block
                # on the OLDEST futures (order preserved) past a high-water
                # mark sized to keep every worker busy.
                high_water = 4 * self.workers + 32
                while len(self._pending) > high_water:
                    self._record(self._pending.pop(0).result())
            else:
                self._record(_score_one((g, p)))

    def _record(self, scores: tuple) -> None:
        sm, m, wfm, acc, iou, e_curve, f_curve = scores
        self._sm.append(sm)
        self._mae.append(m)
        self._wfm.append(wfm)
        self._acc.append(acc)
        self._iou.append(iou)
        self._e_curves.append(e_curve)
        self._f_curves.append(f_curve)

    def _drain(self) -> None:
        for fut in self._pending:
            self._record(fut.result())
        self._pending = []
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def close(self) -> None:
        """Abandon pending work and stop the worker pool — for error paths
        (e.g. a preemption raised mid-sweep): without this, cpu_count//2
        spawned scorer processes keep running and competing with the
        checkpoint save for CPU during the platform's kill grace period."""
        for fut in self._pending:
            fut.cancel()
        self._pending = []
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def sync_across_processes(self) -> None:
        """Gather the per-image accumulators of every process (the
        reference's gather_for_metrics; the identity in one process)."""
        self._drain()
        from ucod_dpl_tpu_torch.parallel.distributed import gather_ragged

        for attr in ("_sm", "_mae", "_wfm", "_acc", "_iou", "_e_curves", "_f_curves"):
            setattr(self, attr, gather_ragged(getattr(self, attr)))

    def get_result(self) -> Dict[str, float]:
        self._drain()
        if not self._e_curves:
            raise ValueError(
                "CODStatistics.get_result: no samples were scored — "
                "is the dataset directory empty or the DATASET name wrong?"
            )
        e_curve = np.mean(np.stack(self._e_curves), axis=0)
        f_curve = np.mean(np.stack(self._f_curves), axis=0)
        return {
            "ACC": float(np.mean(self._acc)),
            "mIOU": float(np.mean(self._iou)),
            "E_MAX": float(e_curve.max()),
            "E_MEAN": float(e_curve.mean()),
            "F_MAX": float(f_curve.max()),
            "F_MEAN": float(f_curve.mean()),
            "SMeasure": float(np.mean(self._sm)),
            "MAE": float(np.mean(self._mae)),
            "WFM": float(np.mean(self._wfm)),
        }
