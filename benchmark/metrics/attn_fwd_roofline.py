"""``attn_fwd_roofline``: the attention forward's share of its roofline.

A span is opened around every call of ``multi_head_attention`` as
``models/dino.py`` binds it (on the card: the packed forward kernel K1 of
``ops/attention.py``), carrying (B, L, D, heads, element bytes).  The
bound of a call is the larger of its two products' operations (``4 B L^2
D``) at 989 TFLOP/s bf16 and its bytes (q, k, v read once, o written once)
at 3.35 TB/s; the metric is the sum of the bounds over the device time of
every operation launched inside the spans, in percent."""

from benchmark.harness.peaks import bound_s


def _shape(q, k, v, num_heads, scale, *args, **kwargs):
    b, l, d = q.shape
    return b, l, d, num_heads, q.element_size()


SPANS = {"attn_fwd": ("ucod_dpl_tpu_torch.models.dino", "multi_head_attention", _shape)}


def bound(b, l, d, heads, esize):
    return bound_s(4.0 * b * l * l * d, 4.0 * b * l * d * esize)


def read(trace, run):
    ops = trace.under("attn_fwd")
    if not ops:
        return None
    device_s = sum(op.end - op.start for op, _ in ops) / 1e9
    spans = trace.spans_named("attn_fwd")
    total = sum(bound(*(int(x) for x in name.split(":")[1].split(","))) for name, *_ in spans)
    return 100.0 * total / device_s
