"""The port's spans (``utils/profiling.py::annotate``) on the CPU.

* with no profiler recording, ``annotate`` returns the shared null context
  and records nothing;
* under ``torch.profiler``, one ``Predictor.predict`` and one
  ``FeatureExtractor.extract`` give their span trees: names, parents, one
  request id a call, and the ``bytes`` of the upload and download;
* every span's start and end lie within 100 us of its ``record_function``
  event in the profiler's own results (one clock);
* the buffer stays bounded;
* the entry and model functions keep their names and signatures;
* the eval loop's stages open spans of the log line's names.
"""

import contextlib
import inspect
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.data import feature_extractor
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.models import dino
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder
from ucod_dpl_tpu_torch import serving
from ucod_dpl_tpu_torch.serving import Predictor
from ucod_dpl_tpu_torch.utils import profiling
from ucod_dpl_tpu_torch.utils.profiling import annotate

DIM, SIZE = 64, 56

PREDICT_TREE = {  # span -> its parent, for one chunk
    "entry.predict": None,
    "entry.load": "entry.predict",
    "entry.fill": "entry.predict",
    "entry.upload": "entry.predict",
    "model.fg_logits_live": "entry.predict",
    "model.dino_forward": "model.fg_logits_live",
    "model.upsample": "entry.predict",
    "entry.download": "entry.predict",
    "entry.unpack": "entry.predict",
}
EXTRACT_TREE = {
    "entry.extract": None,
    "entry.upload": "entry.extract",
    "model.dino_forward": "entry.extract",
    "entry.download": "entry.extract",
    "entry.check": "entry.extract",
    "entry.concat": "entry.extract",
}


def _fe_cfg():
    return CfgNode({
        "type": "dinov2",
        "backbone": "facebook/dinov2-base",
        "backbone_weights": "none",
        "arch": {"hidden_size": DIM, "num_layers": 2, "num_heads": 4, "patch_size": 14, "image_size": SIZE},
    })


@pytest.fixture(scope="module")
def extractor():
    return FeatureExtractor(_fe_cfg(), device="cpu")


@pytest.fixture(scope="module")
def predictor(extractor):
    return Predictor(extractor, init_rev_decoder(0, DIM), image_size=(SIZE, SIZE), feature_size=8, max_batch=4)


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)


@contextlib.contextmanager
def _recorded():
    """A CPU profiler session -> (the profiler, the spans recorded in it)."""
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("warm"):  # the session's first region pays the profiler's own set-up
            pass
        t0 = max((s.end for s in profiling.spans()), default=0)
        yield prof, got
    got.extend(s for s in profiling.spans() if s.start > t0)


def _tree(spans):
    by_id = {s.id: s for s in spans}
    return {s.name: (by_id[s.parent].name if s.parent is not None else None) for s in spans}


def test_off_returns_the_shared_null_context_and_records_nothing(predictor):
    before = profiling.spans()
    a, b = annotate("entry.predict", images=3), annotate("model.dino_forward")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a as got:
        assert got is None
    predictor.predict(_images(2), soft=True)
    assert profiling.spans() == before


def test_off_opens_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with annotate("entry.fill"):
        pass


def test_annotate_keeps_the_region_name_and_attrs():
    with _recorded() as (prof, got):
        with annotate("entry.upload", bytes=12):
            torch.ones(4).sum()
    assert "entry.upload" in {e.name for e in prof.events()}
    (span,) = got
    assert span.name == "entry.upload" and span.attrs == {"bytes": 12}
    assert span.parent is None and span.request == span.id and span.thread == threading.get_ident()
    assert span.start <= span.end


def test_predict_span_tree(predictor):
    with _recorded() as (_, got):
        out = predictor.predict(_images(3), soft=True)
        predictor.predict(_images(2, seed=1), soft=True)
    requests = sorted({s.request for s in got})
    assert len(requests) == 2
    for request, n in zip(requests, (3, 2)):
        spans = [s for s in got if s.request == request]
        assert _tree(spans) == PREDICT_TREE
        assert len(spans) == len(PREDICT_TREE)  # one chunk: each span once
        (root,) = [s for s in spans if s.parent is None]
        assert root.id == request and root.attrs == {"images": n}
        for s in spans:
            assert root.start <= s.start <= s.end <= root.end
    first = [s for s in got if s.request == requests[0]]
    (up,) = [s for s in first if s.name == "entry.upload"]
    (down,) = [s for s in first if s.name == "entry.download"]
    assert up.attrs["bytes"] == 4 * SIZE * SIZE * 3 * 4  # the bucket of 4 images, float32
    assert down.attrs["bytes"] == 4 * SIZE * SIZE * 4 == np.stack(out[:3] + out[:1]).nbytes


def test_predict_chunks_share_one_request(predictor):
    with _recorded() as (_, got):
        predictor.predict(_images(6), soft=False, output_size=(30, 40))
    assert len({s.request for s in got}) == 1
    names = [s.name for s in got]
    assert names.count("entry.predict") == 1
    assert names.count("entry.upload") == names.count("model.dino_forward") == 2  # chunks of 4 and 2
    assert names.count("entry.unpack") == 3  # a chunk each, then the resize to output_size
    (up4, up2) = [s for s in got if s.name == "entry.upload"]
    assert (up4.attrs["bytes"], up2.attrs["bytes"]) == (4 * SIZE * SIZE * 12, 2 * SIZE * SIZE * 12)


def test_extract_span_tree(extractor):
    images = _images(2)
    with _recorded() as (_, got):
        feats = extractor.extract(images)
    assert _tree(got) == EXTRACT_TREE and len(got) == len(EXTRACT_TREE)
    assert len({s.request for s in got}) == 1
    by_name = {s.name: s for s in got}
    assert by_name["entry.extract"].attrs == {"images": 2}
    assert by_name["entry.upload"].attrs["bytes"] == images.nbytes
    assert by_name["entry.download"].attrs["bytes"] == feats.nbytes


def test_spans_share_the_profilers_clock(predictor, extractor):
    with _recorded() as (prof, got):
        predictor.predict(_images(3), soft=True)
        extractor.extract(_images(2))
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert len(got) == len(PREDICT_TREE) + len(EXTRACT_TREE)
    for s in got:
        start, end = min(events[s.name], key=lambda ev: abs(ev[0] - s.start))
        assert abs(start - s.start) < 100_000 and abs(end - s.end) < 100_000, (s.name, start - s.start, end - s.end)


def test_buffer_stays_bounded():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiling.SPAN_BUFFER + 10):
            with annotate("entry.fill"):
                pass
        with annotate("entry.unpack"):
            pass
    spans = profiling.spans()
    assert len(spans) == profiling.SPAN_BUFFER and spans[-1].name == "entry.unpack"


@pytest.mark.parametrize("owner,attr,params", [
    (Predictor, "_first_pass", ["self", "batch", "soft"]),
    (serving, "fg_logits_live", ["backbone_params", "params", "pixels", "dino_cfg", "compute_dtype", "size",
                                 "plain", "quant", "int8_mlp"]),
    (feature_extractor, "dino_forward", ["params", "pixels", "cfg", "compute_dtype", "key_fold", "plain",
                                         "differentiable", "remat", "quant", "int8_mlp", "tp_shard", "sp_shard",
                                         "want_cls_attention"]),
    (FeatureExtractor, "_to_host_f32", ["t", "what"]),
    (dino, "multi_head_attention", ["q", "k", "v", "num_heads", "scale"]),
    (dino, "layernorm_qkv", ["x", "norm", "q", "k", "v", "eps"]),
])
def test_entry_and_model_names_keep_their_signatures(owner, attr, params):
    fn = getattr(owner, attr)
    assert fn.__name__ == attr and list(inspect.signature(fn).parameters)[:len(params)] == params
    if attr == "_to_host_f32":
        assert isinstance(inspect.getattr_static(owner, attr), staticmethod)
    if attr in ("fg_logits_live", "dino_forward"):
        from ucod_dpl_tpu_torch.models import dba

        assert fn is (dba.fg_logits_live if attr == "fg_logits_live" else dino.dino_forward)


def test_eval_stage_opens_a_span_of_its_name():
    from ucod_dpl_tpu_torch.engine.eval_loop import LookTwiceEvaluator

    ev = LookTwiceEvaluator.__new__(LookTwiceEvaluator)
    ev.split = {"first pass": 0.0}
    with _recorded() as (prof, got):
        with ev._stage("first pass"):
            torch.ones(2).sum()
    assert [s.name for s in got] == ["first pass"] and "first pass" in {e.name for e in prof.events()}
    assert ev.split["first pass"] > 0.0
