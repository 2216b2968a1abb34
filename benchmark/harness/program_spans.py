"""The program's own spans in a traced window.

``ucod_dpl_tpu_torch.utils.profiling.spans()`` holds the spans the port
records while a profiler runs, on the profiler's clock (``time.time_ns()``):
``entry.*`` for the host work of ``Predictor.predict`` and
``FeatureExtractor.extract``, ``model.*`` for the model step.  The layer of
a span is its name's first part.  A port without them (no ``spans``, or none
in the window) gives ``None``, so the metrics that read them are left out.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from benchmark.harness.trace import _innermost_segments

COPIES = ("entry.upload", "entry.download")


def read(trace) -> Optional[list]:
    """Every span the program recorded that overlaps the window, or None."""
    from ucod_dpl_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    w0, w1 = trace.window
    got = [s for s in spans() if s.end > w0 and s.start < w1]
    return got or None


def layer(name: str) -> str:
    return name.split(".")[0]


def idle_by_layer(trace, spans, key: Callable[[str], str] = layer) -> Dict[str, float]:
    """Seconds of the window in which the device was idle while a span of
    each layer (``key`` of its name; ``key=str`` splits by span) was the
    innermost open program span on the main thread, its spans clipped to the
    window.  Idle time under no program span is in no layer."""
    thread = threading.main_thread().ident
    w0, w1 = trace.window
    segments = _innermost_segments([(s.name, max(s.start, w0), min(s.end, w1)) for s in spans
                                    if s.thread == thread and s.end > w0 and s.start < w1])
    gaps: List[tuple] = []
    prev = w0
    for st, en in trace.busy_intervals() + [(w1, w1)]:
        if st > prev:
            gaps.append((prev, st))
        prev = max(prev, en)
    idle: Dict[str, float] = defaultdict(float)
    k = 0
    for g0, g1 in gaps:  # both in time order
        while k < len(segments) and segments[k][1] <= g0:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < g1:
            a, b, name = segments[j]
            idle[key(name)] += max(0, min(b, g1) - max(a, g0)) / 1e9
            j += 1
    return dict(idle)


def idle_share(trace, prefix: str) -> Optional[float]:
    """Percent of the window idle while a span of layer ``prefix`` was
    innermost."""
    spans = read(trace)
    if spans is None:
        return None
    return 100.0 * idle_by_layer(trace, spans).get(prefix, 0.0) / trace.window_s


def copy_gbps(trace, spans) -> Optional[float]:
    """The ``bytes`` of the upload and download spans that start in the
    window, over the device time of its ``Memcpy HtoD`` / ``DtoH``
    operations, in GB/s."""
    w0, w1 = trace.window
    moved = sum(s.attrs.get("bytes", 0) for s in spans if s.name in COPIES and w0 <= s.start < w1)
    ns = sum(min(op.end, w1) - max(op.start, w0) for op in trace.ops
             if op.name.startswith("Memcpy") and ("HtoD" in op.name or "DtoH" in op.name) and op.end > w0
             and op.start < w1)
    if not moved or ns <= 0:
        return None
    return moved / ns
