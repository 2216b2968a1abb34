"""``idle_model.infer``: the share of the measured window in which the
device was idle while a ``model.*`` span of the program was the innermost
open one on the host's main thread (``fg_logits_live``, ``dino_forward``,
the Predictor's upsample): the host enqueueing the model step slower than
the card runs it, in percent.  Layer: the model step.  Left out where the
program records no spans (``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(trace, run):
    return program_spans.idle_share(trace, "model")
