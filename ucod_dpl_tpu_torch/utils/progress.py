"""Rate/ETA progress lines for multi-minute waits (cache builds, eval
sweeps), jax-free: the port's copy of :mod:`ucod_dpl_tpu.utils.progress`
(the reference's rich ``ProgressManager``, ``engine/runner/utils.py:16-68``,
as plain log lines)."""

from __future__ import annotations

import time


class ProgressReporter:
    """Logs ``label: done/total (rate/s, ETA mm:ss)`` at most every
    ``interval`` seconds, and a last line on finish."""

    def __init__(self, logger, total: int, label: str, interval: float = 10.0):
        self.logger = logger
        self.total = total
        self.label = label
        self.interval = interval
        self.done = 0
        self._t0 = time.perf_counter()
        self._last = self._t0

    def update(self, n: int = 1) -> None:
        self.done += n
        now = time.perf_counter()
        if now - self._last >= self.interval or self.done >= self.total:
            self._last = now
            rate = self.done / max(now - self._t0, 1e-9)
            remaining = (self.total - self.done) / rate if rate > 0 else 0.0
            self.logger.log(
                f"{self.label}: {self.done}/{self.total} "
                f"({rate:.1f}/s, ETA {int(remaining) // 60}:{int(remaining) % 60:02d})"
            )

    def finish(self) -> None:
        self.done = max(self.done, self.total)
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        self.logger.log(f"{self.label}: done ({self.total} in {elapsed:.1f}s, {self.total / elapsed:.1f}/s)")
