"""Tracing of the port (counterpart of :mod:`ucod_dpl_tpu.utils.profiling`):
``--profile`` on the entry points records a ``torch.profiler`` trace, and
:func:`annotate` opens a span of one of the port's layers.

A span exists only while a ``torch.profiler`` session records (the CLI's
``--profile``, or any caller's ``torch.profiler.profile``).  It is then a
named region of that session's trace and a :class:`Span` in a bounded
in-memory buffer, which :func:`spans` returns.  A span's start and end are
``time.time_ns()``, the Unix-epoch clock the profiler's own events carry, so
the records line up with the device operations of the same trace.  Without
a recording session :func:`annotate` returns one shared null context and
records nothing.

Span names are ``<layer>.<step>``: ``entry.*`` for the host work of
``Predictor.predict`` and ``FeatureExtractor.extract`` (``entry.predict``
and ``entry.extract`` are their roots), ``model.*`` for the model step
(``model.fg_logits_live``, ``model.dino_forward``, ``model.upsample``); the
eval loop's stages keep the names of its log line.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_BUFFER = 1 << 17  # spans kept, newest last: 9 a predict call, about 300 a second at 296px bs16 on an H100


class Span(NamedTuple):
    """One closed span.  ``start`` and ``end``: ``time.time_ns()``;
    ``thread``: ``threading.get_ident()``; ``parent``: the ``id`` of the
    span open around it on its thread (``None`` at the outermost);
    ``request``: the ``id`` of that outermost span, shared by every span
    under one ``predict`` or ``extract`` call; ``attrs``: the counts given
    to :func:`annotate` (``bytes`` for ``entry.upload`` and
    ``entry.download``)."""

    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: Optional[int]
    request: int
    attrs: Dict[str, Any]


_SPANS: deque = deque(maxlen=SPAN_BUFFER)
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the spans open on this thread, innermost last
_OFF = contextlib.nullcontext()


class _Recording:
    """A span while a profiler records: its region and its record."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "start", "region")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if outer is None else outer.id
        self.request = self.id if outer is None else outer.request
        self.start = time.time_ns()  # read before the region opens and after it closes: the span holds it
        self.region = torch.profiler.record_function(self.name)
        self.region.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        try:
            self.region.__exit__(*exc)
        finally:
            end = time.time_ns()
            _OPEN.stack.pop()
            _SPANS.append(Span(self.name, self.start, end, threading.get_ident(), self.id, self.parent,
                               self.request, self.attrs))
        return False


def annotate(name: str, **attrs):
    """A span named ``name`` (a context manager): while a ``torch.profiler``
    session records, a ``record_function`` region of that name and a
    :class:`Span` carrying ``attrs``; otherwise the shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, attrs)


def spans() -> List[Span]:
    """The recorded spans, oldest first: at most :data:`SPAN_BUFFER`, the
    newest.  A reader keeps those inside its own window."""
    return list(_SPANS)


@contextlib.contextmanager
def maybe_profile(enabled: bool, log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace.json``, Chrome trace format) when ``enabled``; the CUDA
    activity is recorded when a card is visible."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
