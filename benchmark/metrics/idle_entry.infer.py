"""``idle_entry.infer``: the share of the measured window in which the
device was idle while an ``entry.*`` span of the program was the innermost
open one on the host's main thread (``Predictor.predict``'s load, batch
fill, upload, download and per-image copies; ``FeatureExtractor.extract``'s
upload, download, finiteness check and concatenation; the calls' own
roots), in percent.  Layer: the entry.  Left out where the program records
no spans (``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(trace, run):
    return program_spans.idle_share(trace, "entry")
