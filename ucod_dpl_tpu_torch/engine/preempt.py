"""Deferred preemption signalling shared by the loops.

Counterpart of :mod:`ucod_dpl_tpu.engine.preempt`.  A SIGTERM/SIGINT
handler only records the signal; loops poll :func:`requested` or call
:func:`check` at safe boundaries (between eval batches) and raise
:class:`Preempted`, so a long validation cannot swallow the platform's
grace period.  Processes that never call :func:`install` (the eval entry)
keep the default signal behaviour and the polls do nothing.  With more
than one process the loops act on the cluster-agreed flag
(:func:`requested_global`, an all-gather MAX over the gloo group of
:mod:`ucod_dpl_tpu_torch.parallel.distributed`), on the fixed schedule of
:class:`GlobalPoll` where the ranks' batch counts differ.
"""

from __future__ import annotations

import signal
from typing import Optional

from ucod_dpl_tpu_torch.parallel.distributed import all_gather_host, process_count

_signum: Optional[int] = None


class Preempted(Exception):
    """Raised by cooperative poll points after a preemption signal."""

    def __init__(self, signum: int):
        super().__init__(f"preemption signal {signum}")
        self.signum = signum


def install() -> None:
    """Install the deferred SIGTERM/SIGINT handler and clear a stale flag."""
    global _signum
    _signum = None

    def handler(signum, frame):
        global _signum
        _signum = signum

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, handler)
        except ValueError:  # not the main thread (e.g. under a test runner)
            pass


def requested() -> Optional[int]:
    """The pending preemption signal number, or None."""
    return _signum


def check() -> None:
    """Raise :class:`Preempted` if a preemption signal is pending."""
    if _signum is not None:
        raise Preempted(_signum)


class GlobalPoll:
    """Preemption polling for loops whose batch counts differ by process
    (the eval sweeps over ragged shards).

    A per-batch :func:`check` is unsound with more than one process: a rank
    that raises alone strands the others in the final metric gather.  So
    every rank runs the same fixed schedule of :func:`requested_global`
    rounds, ``ceil(max local batches / every)`` of them, fired every
    ``every`` local batches and drained in :meth:`finish` by the ranks with
    fewer batches; all ranks see the flag at the same round, so either all
    raise :class:`Preempted` or none does.  In a world of one: a per-batch
    :func:`check` and no collective."""

    def __init__(self, local_batches: int, every: int = 8):
        self.single = process_count() == 1
        self.every = max(int(every), 1)
        self.i = 0
        self.rounds_done = 0
        self.rounds_total = 0
        if not self.single:
            self.rounds_total = -(-int(all_gather_host([local_batches]).max()) // self.every)

    def _round(self) -> None:
        self.rounds_done += 1
        s = requested_global()
        if s is not None:
            raise Preempted(s)

    def step(self) -> None:
        """Call once per local batch."""
        if self.single:
            check()
            return
        self.i += 1
        if self.i % self.every == 0 and self.rounds_done < self.rounds_total:
            self._round()

    def finish(self) -> None:
        """Drain the rounds this rank has not run, so that the schedule is
        the same on every rank; call it before any end-of-sweep collective
        (the metric gather)."""
        while not self.single and self.rounds_done < self.rounds_total:
            self._round()


def clear() -> None:
    global _signum
    _signum = None


def requested_global() -> Optional[int]:
    """The preemption signal every process agrees on: the MAX of the
    processes' local flags, all-gathered over the gloo group.

    The platform signals each process on its own, so the local flags race
    the batch boundaries; ranks that acted on their own flag would save
    different steps or leave the others waiting in the next collective.
    All ranks call this at the same boundary and take the same action.  In a
    world of one: :func:`requested`, no collective."""
    if process_count() == 1:
        return requested()
    return int(all_gather_host([_signum or 0]).max()) or None
