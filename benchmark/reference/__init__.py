"""The plain float32 PyTorch reference of what the cells run.

It follows the published models and the UCOD-DPL paper's modules, not the
port: the DINOv2 / DINOv1 ViT with bicubic position interpolation
(``vit.py``), the DBA decoder with its decoupling, orthogonality loss and the
bilinear upsample and sigmoid of a prediction (``decoder.py``).  It
imports nothing of
``ucod_dpl_tpu_torch`` and takes nothing the port has made: the benchmark
hands both sides the same seeded tensors, and every derived quantity (the
key fold, bf16 or int8 weights) is worked out here
again or not at all.  ``precision.py`` holds the float32 context (TF32 off)
and the fp8 emulation that makes the reference a control.
"""
