"""``lnqkv_roofline``: the fused LayerNorm + q/k/v projections' share of
their roofline.

A span is opened around every call of ``layernorm_qkv`` as
``models/dino.py`` binds it (on the card K6, ``ops/fused_layers.py``: its
statistics pre-pass and main kernel), carrying (rows, D, element bytes).
The bound of a call is the larger of its operations (``2 rows D 3D``) at
989 TFLOP/s bf16 and its bytes (x and the three (D, D) weights read once,
the norm's and the biases' f32 vectors, q, k, v written once) at 3.35 TB/s;
the metric is the sum of the bounds over the device time of every
operation launched inside the spans, in percent."""

from benchmark.harness.peaks import bound_s


def _shape(x, *args, **kwargs):
    d = x.shape[-1]
    return x.numel() // d, d, x.element_size()


SPANS = {"lnqkv": ("ucod_dpl_tpu_torch.models.dino", "layernorm_qkv", _shape)}


def bound(rows, d, esize):
    return bound_s(2.0 * rows * d * 3 * d, (4 * rows * d + 3 * d * d) * esize + 5 * d * 4)


def read(trace, run):
    ops = trace.under("lnqkv")
    if not ops:
        return None
    device_s = sum(op.end - op.start for op, _ in ops) / 1e9
    total = sum(bound(*(int(x) for x in name.split(":")[1].split(","))) for name, *_ in trace.spans_named("lnqkv"))
    return 100.0 * total / device_s
