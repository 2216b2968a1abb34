"""``copy_ms_per_img.infer``: the device time of the window's host<->device
copies (the profiler's ``Memcpy HtoD`` / ``DtoH`` operations: the
Predictor's or extractor's upload of the batch and download of the result),
in milliseconds per image completed.  Layer: the entry
(``serving.py::Predictor``, ``FeatureExtractor.extract``)."""


def read(trace, run):
    if not run.images:
        return None
    w0, w1 = trace.window
    ns = sum(min(op.end, w1) - max(op.start, w0) for op in trace.ops
             if op.name.startswith("Memcpy") and ("HtoD" in op.name or "DtoH" in op.name))
    return ns / 1e6 / run.images
