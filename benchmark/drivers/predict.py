"""Batch prediction: ``Predictor.predict(images, soft=True)``, one client in a
closed loop, each call sent when the last returns.

Traffic parameters (the cell's workload file): ``image_size``, ``batch``
images a call, a ``pool`` of distinct pre-normalised float32 images made
from the seed before the window (the calls cycle through it, ``batch`` at a
time), ``dtype`` of the backbone, ``quantize`` (``null`` or ``"int8"``, the
program's int8 path), ``sample_calls`` (how many calls of the window,
besides the last, are drawn from the seed for the check) and ``limits``.

Check: every kept call's probability maps against the plain float32
reference (``reference/vit.py`` and ``reference/decoder.py``: the ViT, the
decoupling, the decoder body, the bilinear upsample and sigmoid), image by
image: ``prob_rms`` is the largest over the images of the root mean square
gap between the program's and the reference's probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import compare, program, weights
from benchmark.reference import decoder as ref_decoder, vit as ref_vit
from benchmark.reference.precision import Matmul, float32


REFERENCE_BLOCK = 4  # images a reference forward: its float32 activations fit beside the program's peak


class Driver:
    E2E = ("img_per_s", "latency_p95_ms")
    # spans of the traced run that split a call's host time (the breakdown's idle gaps)
    SPANS = {"first_pass": ("ucod_dpl_tpu_torch.serving", "Predictor._first_pass", lambda self, batch, soft: ()),
             "fg_logits_live": ("ucod_dpl_tpu_torch.serving", "fg_logits_live", lambda *a, **k: ())}

    def __init__(self, run):
        from ucod_dpl_tpu_torch import serving
        from ucod_dpl_tpu_torch.models.dba import RevDecoderParams

        self.run = run
        wl, cfg = run.workload, run.config
        self.batch, self.size = wl["batch"], wl["image_size"]
        self.slices = wl["pool"] // self.batch
        masters = weights.make(weights.dino_plan(cfg), run.seed, "weights", run.device)
        dec = weights.make(weights.decoder_plan(cfg), run.seed, "decoder", run.device)
        fe = program.extractor(cfg, masters, run.device, run.dtype, quantize=wl.get("quantize"))
        self.predictor = serving.Predictor(fe, RevDecoderParams(**dec), image_size=(self.size, self.size),
                                           feature_size=cfg["decoder"]["feature_size"], max_batch=self.batch)
        self.pool = pool(run)
        self.images_per_call = self.batch
        self.sampled = sampled_calls(run)
        self.kept, self.last = {}, None
        for _ in range(2):  # the cell's one shape, warmed
            self.call(0)

    def call(self, i: int):
        return self.predictor.predict(pool_slice(self.pool, self.batch, i % self.slices), soft=True)

    def keep(self, i: int, out) -> None:
        self.last = (i, out)
        if i in self.sampled:
            self.kept[i] = out

    def sync(self) -> None:
        self.run.sync()

    def end_to_end(self, window_s: float, calls: int, latencies):
        return {"img_per_s": (calls * self.batch / window_s, "img/s"),
                "latency_p95_ms": (float(np.percentile(np.asarray(latencies), 95)) * 1e3, "ms")}

    def release(self) -> None:
        self.predictor = None

    def check(self):
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        limit = float(self.run.workload["limits"]["prob_rms"])
        if any(out is None or len(out) != self.batch for out in kept.values()):
            return {"prob_rms": (float("inf"), limit)}
        got = {i % self.slices: [] for i in kept}
        for i, out in kept.items():
            got[i % self.slices].append(torch.from_numpy(np.stack(out)))
        ref = reference(self.run, self.pool, sorted(got))
        errs = [e for j, outs in got.items() for out in outs for e in rms(out.to(self.run.device), ref[j])]
        return {"prob_rms": (compare.worst(errs), limit)}


def pool(run) -> np.ndarray:
    wl = run.workload
    return weights.images(run.seed, wl["pool"], wl["image_size"], run.device).cpu().numpy()


def pool_slice(images: np.ndarray, batch: int, j: int) -> np.ndarray:
    return images[j * batch:(j + 1) * batch]


def sampled_calls(run):
    """The window's calls kept for the check (besides the last), from the seed."""
    rng = np.random.default_rng(run.seed)
    return set(int(i) for i in rng.choice(np.arange(1, 64), run.workload["sample_calls"], replace=False))


def rms(got: torch.Tensor, ref: torch.Tensor):
    return (got - ref).flatten(1).pow(2).mean(dim=1).sqrt().tolist()


def reference(run, images: np.ndarray, slices, mm: Matmul = Matmul()):
    """The reference's probabilities of each pool slice in ``slices``."""
    cfg, wl = run.config, run.workload
    w = weights.make(weights.dino_plan(cfg), run.seed, "weights", run.device)
    dec = weights.make(weights.decoder_plan(cfg), run.seed, "decoder", run.device)
    out = {}
    with float32(), torch.no_grad():
        for j in slices:
            px = torch.from_numpy(pool_slice(images, wl["batch"], j)).to(run.device)
            out[j] = torch.cat([
                ref_decoder.probabilities(dec, ref_vit.key_features(w, px[b:b + REFERENCE_BLOCK], cfg, mm=mm),
                                          cfg["decoder"]["feature_size"], wl["image_size"])
                for b in range(0, wl["batch"], REFERENCE_BLOCK)])
    return out


def control(run):
    """The control's reading: the reference with its backbone's products in
    fp8, in the program's place, on the pool's first two slices."""
    images = pool(run)
    slices = range(min(2, run.workload["pool"] // run.workload["batch"]))
    ref, low = reference(run, images, slices), reference(run, images, slices, Matmul(fp8=True))
    errs = [e for j in slices for e in rms(low[j], ref[j])]
    return {"prob_rms": (compare.worst(errs), float(run.workload["limits"]["prob_rms"]))}
