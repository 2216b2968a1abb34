"""Feature extraction: ``FeatureExtractor.extract(images)`` (CORAL's
m-patch cache build), one client in a closed loop.

Traffic parameters: as ``predict.py``'s (``image_size``, ``batch``,
``pool``, ``dtype``, ``quantize``, ``sample_calls``, ``limits``).

Check: every kept call's key features against the plain float32 reference
ViT (``reference/vit.py``), image by image: ``feat_err`` is the largest over
the images of ``||k - k_ref|| / ||k_ref||``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare, program, weights
from benchmark.reference import vit as ref_vit
from benchmark.reference.precision import Matmul, float32


REFERENCE_BLOCK = 2  # images a reference forward at L 2917


class Driver:
    E2E = ("img_per_s",)
    # spans of the traced run that split a call's host time (the breakdown's idle gaps)
    SPANS = {"dino_forward": ("ucod_dpl_tpu_torch.data.feature_extractor", "dino_forward", lambda *a, **k: ()),
             "to_host": ("ucod_dpl_tpu_torch.data.feature_extractor", "FeatureExtractor._to_host_f32",
                         lambda *a, **k: ())}

    def __init__(self, run):
        self.run = run
        wl, cfg = run.workload, run.config
        self.batch, self.size = wl["batch"], wl["image_size"]
        self.slices = wl["pool"] // self.batch
        masters = weights.make(weights.dino_plan(cfg), run.seed, "weights", run.device)
        self.fe = program.extractor(cfg, masters, run.device, run.dtype, quantize=wl.get("quantize"))
        self.pool = weights.images(run.seed, wl["pool"], self.size, run.device).cpu().numpy()
        self.images_per_call = self.batch
        rng = np.random.default_rng(run.seed)
        self.sampled = set(int(i) for i in rng.choice(np.arange(1, 64), wl["sample_calls"], replace=False))
        self.kept, self.last = {}, None
        for _ in range(2):
            self.call(0)

    def call(self, i: int):
        j = i % self.slices
        return self.fe.extract(self.pool[j * self.batch:(j + 1) * self.batch])

    def keep(self, i: int, out) -> None:
        self.last = (i, out)
        if i in self.sampled:
            self.kept[i] = out

    def sync(self) -> None:
        self.run.sync()

    def end_to_end(self, window_s: float, calls: int, latencies):
        return {"img_per_s": (calls * self.batch / window_s, "img/s")}

    def release(self) -> None:
        self.fe = None

    def check(self):
        limit = float(self.run.workload["limits"]["feat_err"])
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        if any(out is None or out.shape[0] != self.batch for out in kept.values()):
            return {"feat_err": (float("inf"), limit)}
        ref = reference(self.run, self.pool, sorted({i % self.slices for i in kept}))
        errs = []
        for i, out in kept.items():
            errs += compare.rel_norms(torch.from_numpy(out).to(self.run.device), ref[i % self.slices]).tolist()
        return {"feat_err": (compare.worst(errs), limit)}


def reference(run, images: np.ndarray, slices, mm: Matmul = Matmul()):
    """The reference's key features of each pool slice in ``slices``."""
    cfg, wl = run.config, run.workload
    w = weights.make(weights.dino_plan(cfg), run.seed, "weights", run.device)
    b, out = wl["batch"], {}
    with float32(), torch.no_grad():
        for j in slices:
            px = torch.from_numpy(images[j * b:(j + 1) * b]).to(run.device)
            out[j] = torch.cat([ref_vit.key_features(w, px[k:k + REFERENCE_BLOCK], cfg, mm=mm)
                                for k in range(0, b, REFERENCE_BLOCK)])
    return out


def control(run):
    """The control's reading: the reference with its products in fp8, in the
    program's place, on the pool's first two slices."""
    wl = run.workload
    images = weights.images(run.seed, wl["pool"], wl["image_size"], run.device).cpu().numpy()
    slices = range(min(2, wl["pool"] // wl["batch"]))
    ref, low = reference(run, images, slices), reference(run, images, slices, Matmul(fp8=True))
    errs = [e for j in slices for e in compare.rel_norms(low[j], ref[j]).tolist()]
    return {"feat_err": (compare.worst(errs), float(wl["limits"]["feat_err"]))}
