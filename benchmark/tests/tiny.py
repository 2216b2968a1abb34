"""A configuration and cells of the benchmark's kinds at sizes a CPU test
run holds: the cells' code paths with small widths, few layers and small
images, the backbone in float32 (the CPU runs the kernels' plain
versions)."""

import copy

from benchmark.harness import manifest

CONFIG = {
    **{k: v for k, v in manifest.config("ucod_dpl_dinov2").items() if k not in ("assumed",)},
    "name": "tiny",
    "image_size": 28,
    "hidden_size": 128,
    "num_layers": 3,
    "num_heads": 2,
    "decoder": {"embed_dim": 64, "feature_size": 8},
}

OVERRIDES = {
    "dinov2-predict-518-bs16": {"image_size": 42, "batch": 4, "pool": 8},
    "dinov1-predict-296-bs16": {"image_size": 24, "batch": 4, "pool": 8},
    "dinov2-extract-756-bs8": {"image_size": 56, "batch": 2, "pool": 4},
}


def config_for(cell):
    base = manifest.workload(cell)["config"]
    cfg = copy.deepcopy(CONFIG)
    if base == "ucod_dpl_dinov1":
        cfg.update(variant="dinov1", patch_size=8, image_size=16, layer_norm_eps=1e-12, use_layerscale=False)
    return cfg


def overrides(cell, **extra):
    return {"config": config_for(cell), "dtype": "float32", **OVERRIDES[cell], **extra}
