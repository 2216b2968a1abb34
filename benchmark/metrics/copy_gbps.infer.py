"""``copy_gbps.infer``: the bytes the program moved between host and card
in the window (the ``bytes`` of its ``entry.upload`` and ``entry.download``
spans: the batch up, the result down), over the device time of the window's
``Memcpy HtoD`` / ``DtoH`` operations, in GB/s.  Layer: the entry.  Left
out where the program records no spans (``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(trace, run):
    spans = program_spans.read(trace)
    return None if spans is None else program_spans.copy_gbps(trace, spans)
