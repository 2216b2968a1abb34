"""UCOD-DPL in PyTorch and CUDA for one NVIDIA H100.

The port of :mod:`ucod_dpl_tpu` (JAX on a TPU), which stays beside it as
the reference.  This package imports ``torch`` and never ``jax``, and
nothing of ``ucod_dpl_tpu`` (it keeps its own copies of the host code it
needs, under ``config/`` and ``utils/``).  It mirrors the JAX package's
layout (``ops/``, ``models/``, ``data/``, ``engine/``, ``parallel/``,
``serving.py``); the kernels the TPU ran in Pallas are hand-written CUDA C++
under ``csrc/``, built at first use (:mod:`ucod_dpl_tpu_torch.ops._build`).

Ported so far: the live 518px serving path (``models/dba.py::fg_logits_live``
behind :class:`ucod_dpl_tpu_torch.serving.Predictor`; kernels K1, K6), its
int8 variant (K8-K11), the LoRA joint train step (K2-K4) and
tensor-parallel feature extraction (``FeatureExtractor(mesh=)``; the
forward at 3 heads a shard, K5's port), with
K7 (LayerNorm + fc1 + GELU) as an exported op, and the stage-1 eval entry
(``python3 -m ucod_dpl_tpu_torch.cli eval``: ``engine.runner.Runner``, the
``data.dataset.CODDataset`` feature-cache build and
``engine.eval_loop.LookTwiceEvaluator``; K1, K6).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level API: a bare `import ucod_dpl_tpu_torch` imports nothing
    if name == "Predictor":
        from ucod_dpl_tpu_torch.serving import Predictor

        return Predictor
    if name == "FeatureExtractor":
        from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor

        return FeatureExtractor
    raise AttributeError(name)
