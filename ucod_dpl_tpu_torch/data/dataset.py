"""COD datasets, the feature-cache build and a host dataloader, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.data.dataset` (the reference's
``data/datasets/base_dataset.py`` and ``dataloader_utils.py``) with the same
on-disk cache layout (``cache_manager.py:63-76``)::

  {cache_dir}/features_cache/{extractor}/{mode}/{DATASET}
  {cache_dir}/pseudo_label_cache/{DATASET}
  {cache_dir}/patch_cache/{extractor}/{mode}/{DATASET}
  {cache_dir}/m_patch_cache/{extractor}/{mode}/{DATASET}

so caches built by the JAX package, by the reference and by the port are
interchangeable.  The one-time feature-cache build runs the DINO backbone
in batches on the extractor's device (the card: K1 and K6, eleven launches
each per forward) while a thread decodes the next batch; arrays are NHWC.
Legacy torch-pickle caches of the reference are read too (CHW -> HWC).
The CORAL stage-2 dataset (``LRDataset``) adds the 3 x 3 grid-patch cache
and the 756px m-patch cache (``lr_dataset.py``).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.data.transforms import (
    image_transform,
    load_image_batch_transform,
    load_image_transform,
    load_label_transform,
    patch_transform,
    resize_bilinear,
)
from ucod_dpl_tpu_torch.parallel.distributed import is_main_process
from ucod_dpl_tpu_torch.utils.fileio import ArrayCache, ImageIO
from ucod_dpl_tpu_torch.utils.logger import get_logger
from ucod_dpl_tpu_torch.utils.progress import ProgressReporter
from ucod_dpl_tpu_torch.utils.registry import DATASETS

_FEATURE_DIM = 768


def _to_hwc(arr: np.ndarray) -> np.ndarray:
    """Cached arrays as HWC (legacy torch caches are CHW)."""
    if arr.ndim == 3 and arr.shape[0] in (1, _FEATURE_DIM) and arr.shape[0] != arr.shape[-1]:
        return np.transpose(arr, (1, 2, 0))
    return arr


# -- the CORAL stage-2 pixel-side geometry, shared by LRDataset and the
#    serving RefinePredictor ---------------------------------------------------

M_PATCH_SLICE = 36
M_PATCH_STRIDE = 18


def grid_patch_arrays(img, image_size: Tuple[int, int], window_size: int) -> np.ndarray:
    """(ws * ws, h, w, 3) normalised grid-patch pixels: one resize of the
    image to the ws x ws grid of ``image_size`` tiles, one normalisation,
    then the tiles in row-major order (elementwise what the reference's
    crop-then-transform loop gives, ``lr_dataset.py:136-152``)."""
    gh, gw = image_size
    ws = window_size
    big = patch_transform(resize_bilinear(img, (ws * gh, ws * gw)))
    return np.stack([big[i * gh : (i + 1) * gh, j * gw : (j + 1) * gw] for i in range(ws) for j in range(ws)])


def slice_m_windows(key: np.ndarray) -> np.ndarray:
    """(54, 54, C) high-res key map -> (4, 36, 36, C) float32 overlapping
    m-patch slices, stride 18 (``lr_dataset.py:154-168``)."""
    s, st = M_PATCH_SLICE, M_PATCH_STRIDE
    return np.stack([key[i * st : i * st + s, j * st : j * st + s, :] for i in range(2) for j in range(2)]
                    ).astype(np.float32)


def fe_image_size(extractor_type: str) -> Tuple[int, int]:
    """The high-res transform's size: 756 (dinov2) or 432 (dinov1), the
    reference's ``feature_extractor_transform`` (``base_dataset.py:107-110``)."""
    return (756, 756) if extractor_type == "dinov2" else (432, 432)


class CacheSet:
    """Per-dataset cache handles in the reference's directory layout."""

    def __init__(self, cache_dir: str, extractor_type: str, mode: str, dataset: str, logger=None):
        self.cache_dir = cache_dir
        self.extractor_type = extractor_type
        self.mode = mode
        self.dataset = dataset
        self.logger = logger
        self._caches: Dict[str, ArrayCache] = {}

    def _path(self, kind: str) -> str:
        if kind == "pseudo_label":
            return os.path.join(self.cache_dir, "pseudo_label_cache", self.dataset)
        return os.path.join(self.cache_dir, f"{kind}_cache", self.extractor_type, self.mode, self.dataset)

    def get(self, kind: str) -> ArrayCache:
        if kind not in self._caches:
            self._caches[kind] = ArrayCache(self._path(kind), logger=self.logger)
        return self._caches[kind]

    def index_exists(self, kind: str) -> bool:
        """The cheap completion probe: a build writes ``index.json`` last and
        atomically, so one stat stands in for ``reopen``'s check of every
        sample file."""
        return os.path.exists(os.path.join(self._path(kind), "index.json"))

    def reopen(self, kind: str) -> ArrayCache:
        """Drop the handle and open the cache again (its integrity check)."""
        self._caches.pop(kind, None)
        return self.get(kind)


@DATASETS.register("USCODDataset")
@DATASETS.register()
class CODDataset:
    """Image/label/feature/pseudo-label dataset (the reference's
    ``BaseCODDataset``/``USCODDataset``)."""

    def __init__(
        self,
        set_cfg,
        feature_extractor_cfg,
        dataset_dir: str,
        cache_dir: str,
        mode: str = "train",
        keep_size: bool = False,
        image_size: Tuple[int, int] = (518, 518),
        require_label: bool = False,
        feature_extractor: Optional[FeatureExtractor] = None,
        cache_build_batch: int = 8,
        logger=None,
    ):
        self.set_cfg = set_cfg
        self.feature_extractor_cfg = feature_extractor_cfg
        self.dataset_dir = dataset_dir
        self.cache_dir = cache_dir
        self.mode = mode
        self.keep_size = keep_size
        self.image_size = tuple(image_size)
        self.require_label = require_label
        self.cache_build_batch = cache_build_batch
        self.logger = logger or get_logger()
        self._feature_extractor = feature_extractor
        self.build_seconds: Optional[float] = None  # host clock of a feature-cache build, when this made one

        self._scan_files()
        self.caches = CacheSet(cache_dir, feature_extractor_cfg.type, mode, set_cfg.DATASET, logger=self.logger)
        self._validate_cache("features")
        if mode == "train":
            # the pseudo-label cache is positional too: a stale one pairs
            # images with another image's labels
            self._validate_cache("pseudo_label")
        if self.caches.get("features").mode == "w":
            self._build_coordinated(("features",), self._build_feature_cache)

    def _cache_identity(self) -> Dict[str, Any]:
        """Count + image-stem fingerprint of the images the cache indexes
        (caches are positional: entry i belongs to ``image_paths[i]``)."""
        stems = "\n".join(p.stem for p in self.image_paths)
        return {"n": len(self.image_paths), "fingerprint": hashlib.sha1(stems.encode()).hexdigest()}

    def _stale_reason(self, kind: str) -> Optional[str]:
        """Why a complete-looking cache does not belong to the dataset, or
        None.  Reference caches carry no fingerprint sidecar: for those only
        the count is checked (a same-size rename goes unseen)."""
        cache = self.caches.get(kind)
        ident = self._cache_identity()
        if len(cache) != ident["n"]:
            return f"{len(cache)} cached entries for {ident['n']} images: the dataset changed since the cache was built"
        meta = cache.read_meta()
        if meta is not None and meta.get("fingerprint") != ident["fingerprint"]:
            return ("image set changed since the cache was built (fingerprint mismatch at equal count: renamed or "
                    "replaced files)")
        return None

    def _validate_cache(self, kind: str) -> None:
        """Invalidate a complete-looking cache whose identity does not match
        the dataset.  With more than one process only process 0 deletes the
        manifest; the others drop the handle to write mode in memory and
        wait in :meth:`_build_coordinated` for the rebuild."""
        cache = self.caches.get(kind)
        if cache.mode != "r":
            return
        why = self._stale_reason(kind)
        if why is None:
            return
        if is_main_process():
            cache.invalidate(why)
        else:
            cache.index_map, cache.mode = {}, "w"

    def _build_coordinated(self, kinds, build_fn, timeout_s: float = 7200.0) -> None:
        """Build the caches ``kinds`` with ``build_fn``.  With more than one
        process, process 0 builds them and the others poll the shared cache
        directory every 2 s until each cache is complete and matches the
        dataset: the ``index.json`` probe first, the full integrity check
        once it passes.  A poll, unlike a collective, has no connection
        timeout while process 0 computes; after ``timeout_s`` the waiters
        give up."""
        if is_main_process():
            build_fn()
            return
        self.logger.log(f"waiting for process 0 to build {kinds} cache(s) for {self.set_cfg.DATASET}")
        deadline = time.monotonic() + timeout_s
        while True:
            bad = [k for k in kinds if not self.caches.index_exists(k)]
            if not bad:
                try:
                    bad = [k for k in kinds if self.caches.reopen(k).mode != "r" or self._stale_reason(k)]
                except (OSError, ValueError):  # a partial state mid-build
                    bad = list(kinds)
                if not bad:
                    return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"timed out after {timeout_s}s waiting for process 0 to build {bad} caches for "
                    f"{self.set_cfg.DATASET} — is the cache directory on a filesystem shared by all processes?"
                )
            time.sleep(2.0)

    # -- files -----------------------------------------------------------------
    def _scan_files(self) -> None:
        self.image_paths: List[Path] = []
        self.label_paths: List[Path] = []
        for ds in self.set_cfg.DATASET.split("+"):
            self.image_paths += ImageIO.list_dir_image(os.path.join(self.dataset_dir, ds, "im"))
            if self.require_label:
                self.label_paths += ImageIO.list_dir_image(os.path.join(self.dataset_dir, ds, "gt"))
        self.image_paths = sorted(self.image_paths)
        if self.label_paths:
            self.label_paths = sorted(self.label_paths)
            if len(self.image_paths) != len(self.label_paths):
                raise ValueError(f"image/label count mismatch: {len(self.image_paths)} vs {len(self.label_paths)}")
            stems = {p.stem for p in self.label_paths}
            for p in self.image_paths:
                if p.stem not in stems:
                    raise ValueError(f"label missing for {p}")

    # -- feature extraction ------------------------------------------------------
    @property
    def feature_extractor(self) -> FeatureExtractor:
        if self._feature_extractor is None:
            self._feature_extractor = FeatureExtractor(self.feature_extractor_cfg)
        if self._feature_extractor.quantize is not None:
            # caches must regenerate bit for bit (the cache-interchange
            # contract); int8 features would poison every later read
            raise ValueError(
                "dataset cache builds require the full-precision extractor; int8 quantization is a serving-only path"
            )
        return self._feature_extractor

    def _build_feature_cache(self) -> None:
        """The one-time DINO sweep over the dataset: each batch of
        ``cache_build_batch`` images runs on the extractor's device while a
        thread decodes, resizes and normalises the next one."""
        t0 = time.perf_counter()
        fe = self.feature_extractor
        cache = self.caches.get("features")
        n = len(self.image_paths)
        bs = self.cache_build_batch
        self.logger.log(f"Building feature cache for {self.set_cfg.DATASET} ({n} images, batch {bs})")
        chunks = [self.image_paths[s : s + bs] for s in range(0, n, bs)]
        progress = ProgressReporter(self.logger, n, f"feature cache {self.set_cfg.DATASET}")
        idx = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(load_image_batch_transform, chunks[0], self.image_size) if chunks else None
            for ci, chunk in enumerate(chunks):
                batch = pending.result()
                if ci + 1 < len(chunks):
                    pending = pool.submit(load_image_batch_transform, chunks[ci + 1], self.image_size)
                for f in fe.extract(batch):
                    cache.write(idx, f)
                    idx += 1
                progress.update(len(chunk))
        cache.flush(meta=self._cache_identity())
        progress.finish()
        self.build_seconds = time.perf_counter() - t0
        self.logger.log(f"Feature cache complete: {idx} samples")

    # -- item access -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        label = None
        if self.label_paths:
            label = load_label_transform(self.label_paths[index], self.image_size, keep_size=self.keep_size)
        features = _to_hwc(self.caches.get("features").read(index))
        pseudo_label = None
        if self.mode == "train":
            pl_cache = self.caches.get("pseudo_label")
            if pl_cache.mode == "r" and len(pl_cache) > index:
                pseudo_label = _to_hwc(pl_cache.read(index))
        item = {
            "pseudo_label": pseudo_label,
            "label": label,
            "features": features,
            "img_path": str(self.image_paths[index]),
        }
        if self.set_cfg.get("require_pixels", False):
            # normalised pixels for paths that train through the backbone (LoRA)
            item["pixels"] = load_image_transform(self.image_paths[index], self.image_size).astype(np.float32)
        return item


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack equal-shape arrays; pass ragged, None and str entries through
    as lists (the reference's ``dataloader_utils.collate_fn:13-39``)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) and all(
            isinstance(v, np.ndarray) and v.shape == vals[0].shape for v in vals
        ):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)) and not isinstance(vals[0], bool):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Host dataloader: shuffling, batching, numpy collation, a background
    prefetch thread, and process sharding (``shard=(index, count)``)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        shard: Optional[tuple] = None,
        pad_shards: bool = False,
    ):
        """``pad_shards``: wrap-pad the global order so every process gets
        the same number of batches (``DistributedSampler`` semantics), which
        training loaders need; eval loaders leave it off, since padding would
        count the wrapped samples twice."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard = shard
        self.pad_shards = pad_shards
        self.seed = seed
        self._epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order of the next iteration to ``epoch``: the
        order is a function of (seed, epoch) alone, so a resumed run replays
        the order the uninterrupted run would have used.  Without a call the
        epoch advances by one per iteration."""
        self._epoch = int(epoch)

    def skip_batches(self, n: int) -> None:
        """Drop the first ``n`` batches of the next iteration without
        loading them (mid-epoch resume)."""
        self._skip_batches = int(n)

    def _indices(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        if self.shard is not None:
            index, count = self.shard
            if self.pad_shards and len(order) % count:
                total = -(-len(order) // count) * count
                order = np.concatenate([order, order[: total - len(order)]])
            order = order[index::count]
        return order

    def __len__(self) -> int:
        n = len(self._indices()) if self.shard is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self, order: np.ndarray) -> Iterator[Dict[str, Any]]:
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._indices()
        self._epoch += 1
        if self._skip_batches:
            # a skipped batch is batch_size indices, so the remaining batch
            # boundaries stay where they were
            order = order[self._skip_batches * self.batch_size :]
            self._skip_batches = 0
        if self.prefetch <= 0:
            yield from self._batches(order)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has stopped, so
            # an abandoned iteration does not leave this thread blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches(order):
                    if not put(batch):
                        return
            except Exception as e:  # raised again on the consumer's side
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer waiting in put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)
        if err:
            raise err[0]


@DATASETS.register()
class LRDataset(CODDataset):
    """CORAL stage-2 dataset: the stage-1 items plus each image's 3 x 3
    grid-patch features (``h_inputs``) and, with ``require_m_patches``, its
    four 756px m-patch feature slices (``m_inputs``), both cached in the
    JAX package's layout (the reference's ``lr_dataset.py``)."""

    def __init__(self, *args, window_size: int = 3, require_m_patches: bool = True, **kwargs):
        self.window_size = window_size
        self.require_m_patches = require_m_patches
        self.patch_build_seconds: Optional[float] = None  # host clock of a patch-cache build, when this made one
        super().__init__(*args, **kwargs)
        kinds = ("patch", "m_patch") if require_m_patches else ("patch",)
        for kind in kinds:
            self._validate_cache(kind)
        if any(self.caches.get(kind).mode == "w" for kind in kinds):
            self._build_coordinated(kinds, self._build_patch_cache)

    def _fe_image_size(self) -> Tuple[int, int]:
        return fe_image_size(self.feature_extractor_cfg.type)

    def _grid_patches(self, img) -> np.ndarray:
        """(ws * ws, h, w, C) key features of the image's grid patches, one
        extractor call."""
        return np.asarray(self.feature_extractor.extract(grid_patch_arrays(img, self.image_size, self.window_size)),
                          np.float32)

    def _m_patches(self, img) -> np.ndarray:
        arr = image_transform(img, self._fe_image_size())
        return slice_m_windows(np.asarray(self.feature_extractor.extract(arr[None]))[0])

    def _build_patch_cache(self) -> None:
        """The one-time sweep: the grid patches of a chunk of images go
        through the extractor in one call (ws^2 crops an image; the chunk is
        ``cache_build_batch // ws^2`` images, so the call stays the size of a
        feature-cache batch) and the chunk's 756px images in another, while
        threads decode the next chunk."""
        t0 = time.perf_counter()
        patch_cache = self.caches.get("patch")
        m_cache = self.caches.get("m_patch") if self.require_m_patches else None
        build_patch = patch_cache.mode == "w"
        build_m = m_cache is not None and m_cache.mode == "w"
        n = len(self.image_paths)
        per = self.window_size ** 2
        self.logger.log(f"Building patch caches for {self.set_cfg.DATASET} ({n} images)")
        chunk = max(1, self.cache_build_batch // per)
        chunks = [self.image_paths[s : s + chunk] for s in range(0, n, chunk)]

        def load_one(path):
            img = ImageIO.read_image(path, "RGB")
            return (grid_patch_arrays(img, self.image_size, self.window_size) if build_patch else None,
                    image_transform(img, self._fe_image_size()) if build_m else None)

        def load_chunk(paths):
            with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
                return list(pool.map(load_one, paths))

        progress = ProgressReporter(self.logger, n, f"patch cache {self.set_cfg.DATASET}")
        idx = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(load_chunk, chunks[0]) if chunks else None
            for ci, paths in enumerate(chunks):
                loaded = pending.result()
                if ci + 1 < len(chunks):
                    pending = pool.submit(load_chunk, chunks[ci + 1])
                if build_patch:
                    feats = self.feature_extractor.extract(np.concatenate([g for g, _ in loaded]))
                    for i in range(len(paths)):
                        patch_cache.write(idx + i, feats[i * per : (i + 1) * per])
                if build_m:
                    keys = self.feature_extractor.extract(np.stack([m for _, m in loaded]))
                    for i in range(len(paths)):
                        m_cache.write(idx + i, slice_m_windows(keys[i]))
                idx += len(paths)
                progress.update(len(paths))
        progress.finish()
        if build_patch:
            patch_cache.flush(meta=self._cache_identity())
        if build_m:
            m_cache.flush(meta=self._cache_identity())
        self.patch_build_seconds = time.perf_counter() - t0

    def get_features(self, img_path: str, crop_center: bool = False):
        """Live multi-resolution extraction of one image: ``(patches,
        m_patches)``; with ``crop_center`` the image's centre half takes its
        place (the CORAL low-confidence fallback, ``lr_dataset.py:82-134``)
        and the result is ``(l (1, h, w, C), patches (1, ws^2, ...), m_patches
        (1, 4, ...) or None)``."""
        img = ImageIO.read_image(img_path, "RGB")
        if crop_center:
            w, h = img.size
            left, top = w // 4, h // 4
            img = img.crop((left, top, left + w // 2, top + h // 2))
        patches = self._grid_patches(img)
        m_patches = self._m_patches(img) if self.require_m_patches else None
        if crop_center:
            key = np.asarray(self.feature_extractor.extract(image_transform(img, self.image_size)[None]))[0]
            return key[None], patches[None], m_patches[None] if m_patches is not None else None
        return patches, m_patches

    def __getitem__(self, index: int) -> Dict[str, Any]:
        items = super().__getitem__(index)
        patch_cache = self.caches.get("patch")
        h_inputs = np.stack([_to_hwc(a) for a in patch_cache.read(index)]) if patch_cache.mode == "r" else None
        m_inputs = None
        if self.require_m_patches:
            m_cache = self.caches.get("m_patch")
            if m_cache.mode == "r":
                m_inputs = np.stack([_to_hwc(a) for a in m_cache.read(index)])
        items.update({"m_inputs": m_inputs, "h_inputs": h_inputs, "index": index})
        return items
