"""``mfu.infer``: the model's operations for the images completed in the
window, over the window, as a share of the H100's dense bf16 peak (989
TFLOP/s at 700 W; the card's power limit is in the result's ``device``).

The operations are those the answer needs, counted from the shapes: the
patch embedding, every block but the last whole (q/k/v, attention's two
products, the out-projection, the MLP), and of the last block its one
product the answer reads (``predict``: the key projection folded into the
decoupling, 2 x embed_dim outputs; ``extract``: the key projection), then
for ``predict`` the decoder's resizes (the decoupled map to the decoder's
grid, the foreground logit to the image).  Elementwise work is not counted.
Layer: the model step (``models/dba.py::fg_logits_live`` ->
``models/dino.py::dino_forward``)."""

from benchmark.harness.peaks import PEAK_BF16


def vit_ops(cfg, size):
    """Multiply-adds x 2 of one image's ViT forward, without its last block."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    n = (size // p) ** 2
    l = n + 1
    f = d * cfg["mlp_ratio"]
    block = 2 * l * d * 3 * d + 4 * l * l * d + 2 * l * d * d + 4 * l * d * f
    return 2 * n * 3 * p * p * d + (cfg["num_layers"] - 1) * block


def ops_per_image(cfg, wl):
    size, d, p = wl["image_size"], cfg["hidden_size"], cfg["patch_size"]
    g, n = size // p, (size // p) ** 2
    if wl["driver"] == "extract":
        return vit_ops(cfg, size) + 2 * n * d * d
    if wl["driver"] != "predict":
        return None
    e2 = 2 * cfg["decoder"]["embed_dim"]
    fs = cfg["decoder"]["feature_size"]
    resize = 2 * fs * g * g * e2 + 2 * fs * g * fs * e2  # (fs, g) rows, then columns
    upsample = 2 * size * fs * fs + 2 * size * fs * size
    return vit_ops(cfg, size) + 2 * n * d * e2 + resize + upsample


def read(trace, run):
    ops = ops_per_image(run.config, run.workload)
    if ops is None or not run.images:
        return None
    return 100.0 * ops * run.images / trace.window_s / PEAK_BF16
