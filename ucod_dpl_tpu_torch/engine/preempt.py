"""Deferred preemption signalling shared by the loops, for one process.

Counterpart of :mod:`ucod_dpl_tpu.engine.preempt`.  A SIGTERM/SIGINT
handler only records the signal; loops poll :func:`requested` or call
:func:`check` at safe boundaries (between eval batches) and raise
:class:`Preempted`, so a long validation cannot swallow the platform's
grace period.  Processes that never call :func:`install` (the eval entry)
keep the default signal behaviour and the polls do nothing.  The
cluster-agreed flag of the JAX package (an all-gather MAX over processes)
is this process's own flag until multi-process runs land (ROADMAP Queue 1
item 13): :func:`requested_global` answers for one process and
:class:`GlobalPoll` is a per-batch :func:`check`.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

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
    (the eval sweeps).  In one process a per-batch :func:`check`; the JAX
    package's fixed schedule of all-gather rounds waits for item 13."""

    def __init__(self, local_batches: int, every: int = 8):
        pass  # the round schedule (every ``every`` of ``local_batches``) needs more than one process

    def step(self) -> None:
        """Call once per local batch."""
        check()

    def finish(self) -> None:
        """Drain the remaining rounds: none in one process."""


def clear() -> None:
    global _signum
    _signum = None


def requested_global() -> Optional[int]:
    """The preemption signal every process agrees on (the JAX package's
    all-gather MAX of the processes' flags): this process's own flag in a
    run of one.  A launch with ``WORLD_SIZE > 1`` raises: multi-process runs
    are ROADMAP Queue 1 item 13."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("the cluster-agreed preemption flag (an all-gather over torch.distributed) is "
                                  "ROADMAP Queue 1 item 13; run one process")
    return requested()
