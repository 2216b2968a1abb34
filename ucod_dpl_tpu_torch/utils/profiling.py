"""Profiling hooks (counterpart of :mod:`ucod_dpl_tpu.utils.profiling`):
``--profile`` on the entry points records a ``torch.profiler`` trace, and
:func:`annotate` names a region of it."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_profile(enabled: bool, log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace.json``, Chrome trace format) when ``enabled``; the CUDA
    activity is recorded when a card is visible."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named trace region for step-level attribution (a context manager:
    ``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)
