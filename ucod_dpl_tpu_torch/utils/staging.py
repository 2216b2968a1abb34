"""Host staging of the entry points: the buffers through which
``Predictor.predict`` and ``FeatureExtractor.extract`` send each batch to
the device and bring each result back.

A :class:`Staging` keeps one host buffer a role (``"input"``: the batch
sent up; ``"result"``: what comes down) and a device, grows it to the
largest request seen and hands out views of its start.  A batch is written
once into memory that is already mapped and crosses the bus once from
there; no call pays for fresh pages.  For a CUDA device the buffers are
pinned, so an upload is a DMA the host does not wait for; for the CPU they
are plain memory and the same logic runs.

A view is valid until the next :meth:`Staging.take` of its role and device.
A caller holds :attr:`Staging.lock` from filling the input to reading the
result, and copies out what it returns: nothing it returns aliases a
buffer.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Tuple

import torch

Key = Tuple[str, torch.device]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def synchronize(device) -> None:
    """Wait for the work queued on ``device``'s current stream (on the CPU
    there is none)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Staging:
    """Reused host buffers of one entry point, one a role and a device."""

    def __init__(self):
        self.lock = threading.RLock()
        # raw bytes; a view gives them the dtype of each request
        self._buffers: Dict[Key, torch.UntypedStorage] = {}
        self._uploads: Dict[Key, "torch.cuda.Event"] = {}

    def take(self, role: str, device, shape, dtype: torch.dtype, span=None) -> torch.Tensor:
        """A host tensor of ``shape`` and ``dtype`` over the start of the
        buffer of ``role`` for ``device``, once the last upload out of that
        buffer has finished.  A buffer smaller than the request is
        replaced by one of its size.  ``span``, the open span of the step
        (``with annotate(...) as span``), gets ``staged=1`` when the
        buffer was reused, ``grew=1`` when it was (re)allocated."""
        key = (role, _device(device))
        upload = self._uploads.pop(key, None)
        if upload is not None:
            upload.synchronize()
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._buffers.get(key)
        grew = buf is None or buf.nbytes() < nbytes
        if grew:
            self._buffers.pop(key, None)
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=key[1].type == "cuda").untyped_storage()
            self._buffers[key] = buf
        if span is not None:
            span.attrs.update(staged=int(not grew), grew=int(grew))
        with torch.inference_mode(False):  # a normal tensor, filled in or out of inference mode
            return torch.empty(0, dtype=dtype).set_(buf, 0, tuple(shape))

    def upload(self, role: str, host: torch.Tensor, device) -> torch.Tensor:
        """``host``, a view :meth:`take` gave for ``role`` and ``device``,
        copied to ``device`` (from pinned memory without waiting; the next
        :meth:`take` of the buffer waits for it)."""
        key = (role, _device(device))
        out = host.to(key[1], non_blocking=True)
        if key[1].type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(key[1]))
            self._uploads[key] = event
        return out

    def download(self, t: torch.Tensor, span=None) -> torch.Tensor:
        """``t``, in its own dtype, copied into the ``"result"`` buffer of
        its device.  From a CUDA device the copy is only enqueued: wait for
        ``t``'s stream (:func:`synchronize`) before reading it."""
        host = self.take("result", t.device, t.shape, t.dtype, span=span)
        host.copy_(t, non_blocking=True)
        return host
