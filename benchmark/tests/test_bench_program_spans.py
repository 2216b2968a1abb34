"""The program spans' readers (``harness/program_spans.py``) on a hand-built
trace: the window's idle time split by the layer of the innermost program
span, and the bytes the entry moved over the device time of its copies."""

import threading

import pytest

from benchmark.harness import manifest, program_spans
from benchmark.harness.trace import DeviceOp, Trace
from ucod_dpl_tpu_torch.utils.profiling import Span

MAIN = threading.main_thread().ident
US = 1000  # ns


def span(name, start, end, thread=MAIN, **attrs):
    return Span(name, start * US, end * US, thread, 0, None, 0, attrs)


def trace(busy, window=(0, 1000), ops=()):
    """A trace whose device ran ``busy`` (intervals in us) inside ``window``."""
    dev = [DeviceOp("kernel", s * US, e * US, ()) for s, e in busy]
    dev += [DeviceOp(n, s * US, e * US, ()) for n, s, e in ops]
    return Trace((window[0] * US, window[1] * US), dev, [], 0)


def seconds(us):
    return us * US / 1e9


def test_nested_spans_innermost_wins():
    # device busy 200-300 and 600-700: idle 0-200, 300-600, 700-1000
    t = trace([(200, 300), (600, 700)])
    spans = [span("entry.predict", 100, 900), span("entry.fill", 150, 250), span("model.dino_forward", 300, 500),
             span("entry.upload", 550, 650)]
    got = program_spans.idle_by_layer(t, spans)
    # entry: 100-150 predict, 150-200 fill, 500-550 predict, 550-600 upload, 700-900 predict
    assert got["entry"] == pytest.approx(seconds(50 + 50 + 50 + 50 + 200))
    assert got["model"] == pytest.approx(seconds(200))
    assert set(got) == {"entry", "model"}


def test_spans_are_clipped_to_the_window():
    t = trace([], window=(100, 400))
    spans = [span("entry.extract", 0, 200), span("model.dino_forward", 350, 600), span("entry.check", 500, 700)]
    got = program_spans.idle_by_layer(t, spans)
    assert got["entry"] == pytest.approx(seconds(100))  # 100-200
    assert got["model"] == pytest.approx(seconds(50))  # 350-400


def test_spans_of_other_threads_are_ignored():
    t = trace([(0, 100)])
    other = threading.main_thread().ident + 1
    spans = [span("entry.predict", 100, 200, thread=other), span("model.dino_forward", 300, 400)]
    got = program_spans.idle_by_layer(t, spans)
    assert got == {"model": pytest.approx(seconds(100))}


def test_idle_outside_every_span_is_in_no_layer():
    t = trace([(400, 500)])
    spans = [span("entry.predict", 100, 300)]
    got = program_spans.idle_by_layer(t, spans)
    assert got == {"entry": pytest.approx(seconds(200))}  # 0-100, 300-400, 500-1000: no layer
    idle_s = t.window_s - t.busy_s
    assert sum(got.values()) < idle_s


def test_copy_gbps():
    ops = [("Memcpy HtoD (Pageable -> Device)", 100, 200), ("Memcpy DtoH (Device -> Pageable)", 500, 600),
           ("Memcpy DtoD (Device -> Device)", 700, 800), ("Memset (Device)", 800, 900)]
    t = trace([], ops=ops)
    spans = [span("entry.upload", 90, 210, bytes=3_000_000), span("entry.download", 480, 620, bytes=1_000_000),
             span("entry.fill", 0, 90, bytes=5), span("entry.upload", 1100, 1200, bytes=7)]
    # 4 MB over 200 us of host<->device copies: 20 GB/s
    assert program_spans.copy_gbps(t, spans) == pytest.approx(20.0)
    assert program_spans.copy_gbps(trace([]), spans) is None


def test_metrics_read_nothing_without_program_spans(monkeypatch):
    from ucod_dpl_tpu_torch.utils import profiling

    t = trace([(0, 10)], window=(-2000, -1000))  # a window in which the program recorded nothing
    for name in ("idle_entry.infer", "idle_model.infer", "copy_gbps.infer"):
        assert manifest.metric(name).read(t, None) is None
    monkeypatch.delattr(profiling, "spans")  # a port that records no spans
    for name in ("idle_entry.infer", "idle_model.infer", "copy_gbps.infer"):
        assert manifest.metric(name).read(t, None) is None


def test_metrics_read_the_programs_spans(monkeypatch):
    from ucod_dpl_tpu_torch.utils import profiling

    t = trace([(200, 300)], ops=[("Memcpy HtoD (Pageable -> Device)", 200, 300)])
    spans = [span("entry.predict", 0, 800), span("entry.upload", 150, 300, bytes=500_000),
             span("model.fg_logits_live", 300, 600)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert manifest.metric("idle_entry.infer").read(t, None) == pytest.approx(100 * (200 + 200) / 1000)
    assert manifest.metric("idle_model.infer").read(t, None) == pytest.approx(100 * 300 / 1000)
    assert manifest.metric("copy_gbps.infer").read(t, None) == pytest.approx(5.0)


def test_idle_by_span_name():
    t = trace([(200, 300)])
    spans = [span("entry.predict", 0, 1000), span("entry.fill", 100, 250), span("entry.unpack", 300, 400)]
    got = program_spans.idle_by_layer(t, spans, key=str)
    assert got == {"entry.predict": pytest.approx(seconds(100 + 600)), "entry.fill": pytest.approx(seconds(100)),
                   "entry.unpack": pytest.approx(seconds(100))}
