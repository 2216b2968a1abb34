"""The traced run: the benchmark's spans, the profiler and the reduction of
its trace to what the per-layer metrics read.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<name>``
(a span that carries shapes: ``bench.<name>:<n>,<n>,...``).  The harness
opens ``bench.window`` around the measured window and ``bench.call`` around
each call; a metric file (or a driver) declares in ``SPANS`` the program
functions it wants a span around, by the module that binds the name and the
attribute (``Class.method`` for a method): the wrapper is installed for the
traced window only.

:func:`reduce` reads the profiler's events once: every device operation
(kernel, copy, fill) in the window, with the benchmark spans that were open
on the host thread that launched it (through the launch's correlation id),
and the spans themselves.  Times are nanoseconds on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench."


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def installed(span_specs: Dict[str, Tuple[str, str, Callable]]):
    """Wrap each ``module.attr`` of ``span_specs`` (name -> (module, attr,
    shape(*args, **kwargs) -> tuple)) in a span named after it and its
    shapes; restore the originals on exit."""
    restore = []
    try:
        for name, (module, attr, shape) in span_specs.items():
            owner = importlib.import_module(module)
            *path, attr_name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            raw = inspect.getattr_static(owner, attr_name)
            orig = getattr(owner, attr_name)

            def wrapper(*args, __orig=orig, __name=name, __shape=shape, **kwargs):
                dims = ",".join(str(int(x)) for x in __shape(*args, **kwargs))
                with torch.profiler.record_function(f"{PREFIX}{__name}:{dims}"):
                    return __orig(*args, **kwargs)

            functools.update_wrapper(wrapper, orig)  # the program's launch counters live in __dict__
            setattr(owner, attr_name, staticmethod(wrapper) if isinstance(raw, staticmethod) else wrapper)
            restore.append((owner, attr_name, raw, orig, wrapper))
        yield
    finally:
        for owner, attr_name, raw, orig, wrapper in reversed(restore):
            for k, v in vars(wrapper).items():
                if k != "__wrapped__":
                    setattr(orig, k, v)
            setattr(owner, attr_name, raw)


@dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    spans: Tuple[str, ...]  # benchmark spans open at the launch, outermost first


@dataclass
class Trace:
    window: Tuple[int, int]
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, int, int]]  # (name, start, end, thread)
    main_thread: int
    unplaced: int = 0  # device operations of the window whose launch was not found
    _busy: Optional[List[Tuple[int, int]]] = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, sorted."""
        if self._busy is None:
            w0, w1 = self.window
            merged: List[List[int]] = []
            for s, e in sorted((max(op.start, w0), min(op.end, w1)) for op in self.ops):
                if e <= s:
                    continue
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._busy = [(s, e) for s, e in merged]
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def under(self, name: str) -> List[Tuple[DeviceOp, str]]:
        """Device operations launched inside a span ``bench.<name>[:dims]``,
        each with that span's full name."""
        key, out = PREFIX + name, []
        for op in self.ops:
            for s in op.spans:
                if s == key or s.startswith(key + ":"):
                    out.append((op, s))
                    break
        return out

    def spans_named(self, name: str) -> List[Tuple[str, int, int, int]]:
        key = PREFIX + name
        return [s for s in self.spans if s[0] == key or s[0].startswith(key + ":")]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time in the window, and the
        window's idle time split by the innermost benchmark span open on the
        host's main thread during it (what the host was doing)."""
        w0, w1 = self.window
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            d = min(op.end, w1) - max(op.start, w0)
            if d > 0:
                by_name[op.name] += d / 1e9
        idle: Dict[str, float] = defaultdict(float)
        segments = _innermost_segments([(n, st, en) for n, st, en, th in self.spans if th == self.main_thread])
        gaps, prev = [], w0
        for st, en in self.busy_intervals() + [(w1, w1)]:
            if st > prev:
                gaps.append((prev, st))
            prev = max(prev, en)
        k = 0
        for g0, g1 in gaps:  # both in time order: split each gap by the span open
            while k < len(segments) and segments[k][1] <= g0:
                k += 1
            j = k
            while j < len(segments) and segments[j][0] < g1:
                a, b, n = segments[j]
                idle[n] += (min(b, g1) - max(a, g0)) / 1e9
                j += 1
        return {
            "device_ops": [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        }


def _innermost_segments(spans) -> List[Tuple[int, int, str]]:
    """Nested spans ``(name, start, end)`` of one thread -> the time
    segments over which each was the innermost open one, in order."""
    points = sorted([(s, 1, -e, n) for n, s, e in spans] + [(e, 0, 0, n) for n, s, e in spans])
    out: List[Tuple[int, int, str]] = []
    stack: List[str] = []
    last = None
    for t, is_start, _, n in points:
        if stack and last is not None and t > last:
            out.append((last, t, stack[-1]))
        if is_start:
            stack.append(n)
        elif n in stack:
            stack.remove(n)  # nested spans close innermost first: this is the top
        last = t
    return out


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _kind(e, cpu_names) -> str:
    """``kernel`` (a kernel, copy or fill on the device), ``annotation`` (a
    range's device-side copy), ``launch`` (a CUDA runtime or driver call),
    ``span`` (a benchmark span) or ``op`` (another host event)."""
    from torch.autograd import DeviceType

    name = e.name()
    if e.device_type() != DeviceType.CPU:
        return "annotation" if name in cpu_names else "kernel"
    if name.startswith(PREFIX):
        return "span"
    if name.startswith("cu") and "::" not in name:
        return "launch"
    return "op"


def reduce(prof) -> Trace:
    """The window's device operations and spans from a stopped profiler.

    A kernel is tied to the host thread and time of its launch through its
    CUPTI correlation id (the runtime call that launched it), or through
    the PyTorch operator it was launched under.  Operators and spans carry
    PyTorch's thread ids, runtime calls the system's: runtime calls made
    under an operator give the mapping between the two."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu_names = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    ops_by_id: Dict[int, Tuple[int, int]] = {}
    spans: List[Tuple[str, int, int, int]] = []
    launches: Dict[int, Tuple[int, int, int]] = {}  # correlation -> (start, system thread, operator id)
    dev = []
    for e in events:
        kind = _kind(e, cpu_names)
        if kind == "kernel":
            dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id(), e.linked_correlation_id()))
        elif kind == "launch":
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id(), e.linked_correlation_id())
        elif kind in ("op", "span"):
            ops_by_id[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            if kind == "span":
                spans.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
    windows = [s for s in spans if s[0] == PREFIX + "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} measured windows, expected 1")
    _, w0, w1, main = windows[0]
    system_to_torch = {}
    for _, sys_tid, op in launches.values():
        if op in ops_by_id:
            system_to_torch.setdefault(sys_tid, ops_by_id[op][1])
    # the launch (time, PyTorch thread) of every device operation
    where: List[Optional[Tuple[int, int]]] = []
    for _, _, _, corr, linked in dev:
        launch = launches.get(corr)
        if launch is not None and launch[1] in system_to_torch:
            where.append((launch[0], system_to_torch[launch[1]]))
        else:
            where.append(ops_by_id.get(linked))
    # the spans open at each launch: a sweep per thread over spans and launches in time order
    by_thread: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for n, s, e, th in spans:
        by_thread[th].append((s, e, n))
    queries: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i, w in enumerate(where):
        if w is not None:
            queries[w[1]].append((w[0], i))
    stacks: List[Tuple[str, ...]] = [()] * len(dev)
    for th, items in queries.items():
        sp = sorted(by_thread.get(th, []))
        items.sort()
        open_: List[Tuple[int, str]] = []
        j = 0
        for t, i in items:
            while j < len(sp) and sp[j][0] <= t:
                open_ = [o for o in open_ if o[0] >= sp[j][0]] + [(sp[j][1], sp[j][2])]
                j += 1
            open_ = [o for o in open_ if o[0] >= t]
            stacks[i] = tuple(n for _, n in open_)
    ops = [DeviceOp(n, s, e, stacks[i]) for i, (n, s, e, _, _) in enumerate(dev) if e > w0 and s < w1]
    unplaced = sum(1 for i, (n, s, e, _, _) in enumerate(dev) if e > w0 and s < w1 and where[i] is None)
    return Trace((w0, w1), ops, spans, main, unplaced=unplaced)
