"""Multi-device dry run of the port: every sharded training and eval path
on one device named once per mesh coordinate.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``,
which runs on 8 virtual CPU devices.  Here the mesh is
``build_mesh(cfg, devices=[device] * n)``: the CPU, or one card, repeated.
Run from the repository root::

    python3 -m ucod_dpl_tpu_torch.tools.dryrun_multichip [N] [--device cpu|cuda] [--processes P]

``N`` (default 8) devices; the card unless ``--device cpu``.  The parts, in
the JAX function's order and at its shapes (each raises on failure; the
function returns the numbers it checked):

  1. the stage-1 step and the discriminator step (decoder dim 768,
     ``feature_size`` 17, a batch of ``2 * data`` 8 x 8 feature maps):
     finite losses;
  2. the tensor-parallel ViT forward (dinov2, 28px, patch 14, hidden 768, 2
     layers, 12 heads, mlp ratio 2, layerscale) over ``{"data": N/2,
     "model": 2}`` against the unsharded forward;
  3. a CORAL refiner step (2 x 2 windows of 8px, 8 heads, the distillation
     loss, AdamW): a finite loss;
  4. the Runner's TP eval (``tpu_cfg.mesh = {"data": N/2, "model": 2}``,
     LookTwice over a synthetic set of 3 images): finite MAE and
     S-measure, and its TP ``extract`` against an unsharded extractor on
     the same weights;
  5. the LoRA joint step (rank 2, alpha 4, remat on): a finite loss and
     adapter gradient;
  6. the sequence-parallel forward over ``{"data": N/4, "seq": 4}`` (5
     tokens padded to 8 on the ring) against unsharded, and the SP LoRA
     step's loss against the unsharded step's;
  7. the 2D forward over ``{"data": N/4, "model": 2, "seq": 2}`` against
     unsharded;
  8. with ``processes`` P > 0: the LoRA step on a ``{"seq": P}`` mesh over P
     processes (gloo on the CPU, NCCL on cards ``cuda:0 .. P-1``), each rank
     this module run as ``--rank-worker SPEC``: the ranks' states equal bit
     for bit, and their loss and LoRA gradient norm against the one-process
     ring's step on the same inputs.

In one process the ``data`` axis splits a batch in extraction (parts 2, 4, 6
and 7 run each data coordinate's rows); the training steps (parts 1, 3, 5
and 6's step) run the global batch on data coordinate 0's device, the
function the JAX package's GSPMD steps compute.

On the CPU everything is float32 and the comparisons are the JAX function's
(rtol 2e-4, atol 2e-5; the SP step's loss at rtol 1e-5).  On the card the
backbone runs in bf16 through the kernels and each comparison is the
project's composed rule: ``max|sharded - f32 plain| <= 1.5 * max|bf16 plain
- f32 plain| + 1e-3``, both references unsharded; the part-4 backbone is 256
wide (4 heads of 64) there, as K6 takes ``hidden % 256 == 0``.  Every
backbone part resets the kernels' launch counts before the path it drives,
reads them after it, and fails unless the kernels it should reach launched
the expected number of times and no other did: the TP forwards the packed
attention forward (K1's wrapper, the port of K5's tensor-parallel shards),
the SP and 2D forwards the forward with log-sum-exp (K2), the LoRA steps K2
and the backward (K3/K4).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ucod_dpl_tpu_torch import ops
from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.models.convert import tree_leaves, tree_map
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder, rev_decoder_forward
from ucod_dpl_tpu_torch.models.dino import DinoConfig, cast_params, dino_forward, init_dino
from ucod_dpl_tpu_torch.models.discriminator import init_discriminator
from ucod_dpl_tpu_torch.parallel.mesh import build_mesh, data_sharding
from ucod_dpl_tpu_torch.tools.common import REPO, child_env, write_cod_set

DIM, FEATURE_SIZE = 768, 17
WINDOWS, WINDOW_LENGTH = 2, 8
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
# the backbone of parts 2 and 5-8: ViT-B's head geometry at 28px (2 x 2
# patches + CLS = 5 tokens)
BACKBONE = DinoConfig(variant="dinov2", image_size=28, patch_size=14, hidden_size=768, num_layers=2, num_heads=12,
                      mlp_ratio=2, use_layerscale=True)
STAGE1 = {"model_cfg": {"dim": DIM, "feature_size": FEATURE_SIZE, "ema_weight": 0.99, "dis_use_features": False},
          "train_cfg": {"max_epoch": 25, "start_finetune": -5, "merge_method": "dis", "lr0": 2e-4, "dis_lr0": 1e-3,
                        "step_lr_gamma": 0.95, "step_lr_size": 25}}
LORA = {"rank": 2, "alpha": 4.0, "remat": True}


def lora_cfg() -> CfgNode:
    """The stage-1 config with the LoRA joint step's adapters."""
    d = json.loads(json.dumps(STAGE1))
    d["model_cfg"]["lora"] = dict(LORA)
    return CfgNode(d)


def dryrun_inputs(n_devices: int) -> Dict[str, np.ndarray]:
    """The inputs of every part: the JAX function's arrays, drawn from
    ``numpy.random.default_rng(0)`` in its order and shapes."""
    bs = (n_devices // (2 if n_devices % 2 == 0 else 1)) * 2
    rng = np.random.default_rng(0)
    x = {"features": rng.standard_normal((bs, 8, 8, DIM)).astype(np.float32),
         "plabels": (rng.random((bs, 8, 8, 1)) > 0.5).astype(np.float32),
         "tp_pixels": rng.standard_normal((bs, 28, 28, 3)).astype(np.float32),
         "l_features": rng.standard_normal((bs, WINDOW_LENGTH, WINDOW_LENGTH, DIM)).astype(np.float32),
         "h_features": rng.standard_normal((bs, WINDOWS * WINDOWS, WINDOW_LENGTH, WINDOW_LENGTH, DIM)
                                           ).astype(np.float32),
         "preds": rng.standard_normal((bs, WINDOW_LENGTH, WINDOW_LENGTH, 1)).astype(np.float32)}
    if n_devices % 2 == 0:
        x["runner_pixels"] = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    x["lora_pixels"] = rng.standard_normal((bs, 28, 28, 3)).astype(np.float32)
    if n_devices % 2 == 0:
        x["sp_pixels"] = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
        x["sp_step_pixels"] = rng.standard_normal((bs, 28, 28, 3)).astype(np.float32)
    if n_devices % 8 == 0:
        x["pixels_2d"] = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    return x


# -- checks ---------------------------------------------------------------------------


class _Part:
    """A part's wall seconds and the kernels' launches of the path it drives
    (:meth:`drive`: counts set to 0 just before, read just after)."""

    def __init__(self, number: int, device: torch.device):
        self.number, self.device = number, device
        self.result: Dict[str, Any] = {"launches": {}}
        self.t0 = time.perf_counter()

    def drive(self, name: str, fn: Callable[[], Any]):
        _sync(self.device)
        ops.reset_launches()
        out = fn()
        _sync(self.device)
        self.result["launches"][name] = {k: v for k, v in ops.launches().items() if v}
        return out

    def expect(self, name: str, want: Dict[str, int]) -> None:
        """On the card: the launches of ``name`` are exactly ``want`` and no
        other kernel launched."""
        if self.device.type != "cuda":
            return
        got = self.result["launches"][name]
        if got != want:
            raise AssertionError(f"part {self.number} ({name}): kernel launches {got}, expected {want} and no other")

    def fail(self, msg: str):
        raise AssertionError(f"part {self.number}: {msg}")

    def close(self) -> Dict[str, Any]:
        self.result["seconds"] = time.perf_counter() - self.t0
        return self.result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(part: _Part, what: str, value: float) -> float:
    if not np.isfinite(value):
        part.fail(f"{what} is not finite: {value}")
    return value


def _close(part: _Part, what: str, got: torch.Tensor, f32: torch.Tensor, bf16: Optional[torch.Tensor],
           **tol) -> Dict[str, float]:
    """``got`` against the unsharded f32 result: at ``tol`` (the CPU, f32),
    or within the composed rule against the bf16 plain result's error (the
    card).  Returns the checked numbers."""
    got, f32 = got.detach().float().cpu(), f32.detach().float().cpu()
    if got.shape != f32.shape or not torch.isfinite(got).all():
        part.fail(f"{what}: shape {tuple(got.shape)} (want {tuple(f32.shape)}), "
                  f"finite {bool(torch.isfinite(got).all())}")
    err = (got - f32).abs().max().item()
    if bf16 is None:
        try:
            np.testing.assert_allclose(got.numpy(), f32.numpy(), **tol)
        except AssertionError as e:
            raise AssertionError(f"part {part.number} ({what}) against unsharded: {e}") from None
        return {"max_abs_err": err, **tol}
    err_plain = (bf16.detach().float().cpu() - f32).abs().max().item()
    bound = 1.5 * err_plain + 1e-3
    if not err <= bound:
        part.fail(f"{what}: max|sharded kernels - f32 plain| {err:.6g} exceeds 1.5 * {err_plain:.6g} + 1e-3")
    return {"max_abs_err": err, "bf16_plain_err": err_plain, "bound": bound}


def _loss_close(part: _Part, what: str, got: float, f32: float, bf16: Optional[float]) -> Dict[str, float]:
    return _close(part, what, torch.tensor([got]), torch.tensor([f32]), None if bf16 is None else torch.tensor([bf16]),
                  rtol=LOSS_RTOL, atol=0.0)


@contextlib.contextmanager
def _full_f32():
    """float32 matmuls and convolutions in full precision (no TF32) while
    the references run."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _t(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _data_slices(mesh, batch: int) -> List[slice]:
    slices = data_sharding(mesh, batch)
    return slices[:1] if slices[0] == slice(None) else slices


def _backbones(params: Dict[str, Any], device: torch.device):
    """(f32 params, params of the compute dtype) on ``device``: bf16 on the
    card, the f32 ones on the CPU."""
    f32 = tree_map(lambda t: t.to(device), params)
    return f32, (cast_params(f32, torch.bfloat16) if device.type == "cuda" else f32)


def _unsharded(params: Dict[str, Any], pixels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode():
        return dino_forward(params, pixels, BACKBONE, compute_dtype=dtype, plain=True)["key_features"]


def _references(params: Dict[str, Any], pixels: np.ndarray, device: torch.device):
    """The unsharded plain key features: (f32, bf16 on the card or None)."""
    f32, low = _backbones(params, device)
    px = _t(pixels, device)
    with _full_f32():
        ref = _unsharded(f32, px, torch.float32)
    return ref, (_unsharded(low, px, torch.bfloat16) if device.type == "cuda" else None)


def _ring_pairs(seq_len: int, n: int, model: int = 1) -> int:
    """The ring's K2 (and K3/K4) calls a layer of one data coordinate: per
    model shard, query chunk and key chunk with a real key."""
    from ucod_dpl_tpu_torch.parallel.sp import chunk_kv_lens

    return model * n * sum(1 for k in chunk_kv_lens(seq_len, n) if k)


def _tokens(cfg: DinoConfig) -> int:
    return (cfg.image_size // cfg.patch_size) ** 2 + 1


# -- parts ------------------------------------------------------------------------------


def stage1_steps(decoder, decoder_ema, dis_params, dis_stats, features: np.ndarray, plabels: np.ndarray,
                 device, number: int = 1):
    """Part 1: one stage-1 step, then one discriminator step, from the given
    trees on ``device``.  Returns (the part's numbers, the stepped state)."""
    from ucod_dpl_tpu_torch.engine.train_step import init_train_state, make_discriminator_step, make_train_step

    device = torch.device(device)
    part = _Part(number, device)
    cfg = CfgNode(json.loads(json.dumps(STAGE1)))
    state = init_train_state(decoder, decoder_ema, dis_params, dis_stats, cfg.train_cfg, device)
    f, pl = _t(features, device), _t(plabels, device)
    with _full_f32():
        aux = make_train_step(cfg)(state, f, pl, 0.0, 1.0)
        dis_aux = make_discriminator_step(cfg)(state, f, pl)
    part.result["loss"] = _finite(part, "train loss", float(aux["loss"]))
    part.result["dis_train_loss"] = _finite(part, "discriminator loss", float(dis_aux["dis_train_loss"]))
    return part.close(), state


def tp_forward(mesh, params: Dict[str, Any], pixels: np.ndarray, number: int = 2) -> Dict[str, Any]:
    """Part 2: the tensor-parallel forward over ``mesh``'s ``model`` axis,
    each data coordinate its rows, against the unsharded forward."""
    from ucod_dpl_tpu_torch.parallel.tp import shard_dino_params

    device = mesh.devices.flat[0]
    part = _Part(number, device)
    _, low = _backbones(params, device)
    dtype = low["layers"][0]["fc1"]["w"].dtype
    shards = shard_dino_params(low, mesh)
    slices = _data_slices(mesh, pixels.shape[0])

    def run():
        with torch.inference_mode():
            return torch.cat([dino_forward(shards[d], _t(pixels[sl], mesh.device(data=d)), BACKBONE,
                                           compute_dtype=dtype, tp_shard=(mesh, "model"))["key_features"].to(device)
                              for d, sl in enumerate(slices)])

    kf = part.drive("tp forward", run)
    part.expect("tp forward", {"K1": (BACKBONE.num_layers - 1) * mesh.shape["model"] * len(slices)})
    part.result["key_features"] = tuple(kf.shape)
    part.result.update(_close(part, "TP key features", kf, *_references(params, pixels, device), **FWD_TOL))
    return part.close()


def refiner_step(refiner, decoder, l_features: np.ndarray, h_features: np.ndarray, preds: np.ndarray, device,
                 number: int = 3) -> Dict[str, Any]:
    """Part 3: one CORAL refiner step (the distillation loss against the
    frozen decoder's window targets, AdamW with optax's defaults) from the
    given trees.  Returns the part's numbers (the loss before the step)."""
    from ucod_dpl_tpu_torch.models.udlr import refiner_distillation_loss, sparse_refiner_forward

    device = torch.device(device)
    part = _Part(number, device)
    trainable = tree_map(lambda t: t.detach().to(device, torch.float32).clone().requires_grad_(True), refiner)
    decoder = tree_map(lambda t: t.detach().to(device), decoder)
    opt = torch.optim.AdamW(tree_leaves(trainable), lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    lf, hf, pr = _t(l_features, device), _t(h_features, device), _t(preds, device)
    with _full_f32():
        out = sparse_refiner_forward(trainable, lf, hf, pr, window_size=WINDOWS, threshold=0.0015)
        with torch.no_grad():
            h_flat = hf.reshape(-1, WINDOW_LENGTH, WINDOW_LENGTH, hf.shape[-1])
            targets = (torch.sigmoid(rev_decoder_forward(decoder, h_flat, with_loss=False)[0]) > 0.5).float()
        loss = refiner_distillation_loss(out, pr, targets, window_size=WINDOWS)
        opt.zero_grad()
        loss.backward()
        opt.step()
    part.result["loss"] = _finite(part, "refiner loss", float(loss.detach()))
    return part.close()


def runner_cfg(root: str, mesh_cfg: Dict[str, int], hidden: int) -> CfgNode:
    """The JAX eval fixture's tiny configuration (56px, 2 layers, 4 heads of
    ``hidden / 4``) with ``tpu_cfg.mesh``; float32 on the CPU."""
    return CfgNode({
        "work_dir": os.path.join(root, "work"), "mode": "eval", "seed": 42,
        "model_cfg": {"dim": hidden, "feature_size": 8, "dis_use_features": False, "ema_weight": 0.99},
        "val_cfg": {"look_twice": True, "look_twice_th": 0.95, "expand_type": "dynamic", "enable_val": True},
        "log_cfg": {"log_path": os.path.join(root, "logs"), "multi_rank": [0]},
        "tpu_cfg": {"mesh": dict(mesh_cfg)},
        "dataset_cfg": {
            "dataset_dir": os.path.join(root, "RefCOD"), "cache_dir": os.path.join(root, "cache"),
            "valset_cfg": {"DATASET": "TINY", "require_label": True, "image_size": (56, 56), "keep_size": True},
            "trainset_cfg": {"DATASET": "TINY", "require_label": False, "image_size": (56, 56), "bkg_th": 0.6},
            "val_loader_cfg": {"batch_size": 1}, "trainloader_cfg": {"batch_size": 2, "shuffle": True},
            "feature_extractor_cfg": {"type": "dinov2", "backbone": "facebook/dinov2-base",
                                      "backbone_weights": os.path.join(root, "nonexistent"),
                                      "arch": {"hidden_size": hidden, "num_layers": 2, "num_heads": 4,
                                               "patch_size": 14, "image_size": 56}},
        },
    })


def runner_tp_eval(n_devices: int, device, pixels: np.ndarray, number: int = 4) -> Dict[str, Any]:
    """Part 4: ``Runner(mode="eval")`` over ``tpu_cfg.mesh = {"data": n/2,
    "model": 2}`` on ``device`` named n times, LookTwice over a synthetic
    set of 3 images; then its TP ``extract`` against an unsharded extractor
    on the same weights."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.engine.runner import Runner

    device = torch.device(device)
    part = _Part(number, device)
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="ucod_dryrun_") as root:
        write_cod_set(os.path.join(root, "RefCOD", "TINY"), 3, "rect")
        cfg = runner_cfg(root, {"data": n_devices // 2, "model": 2}, 256 if cuda else 64)
        if not cuda:
            cfg.tpu_cfg.compute_dtype = "float32"

        def run():  # the Runner builds the feature cache, then LookTwice
            runner = Runner(cfg, mode="eval", device=device, devices=[device] * n_devices)
            if runner.feature_extractor.tp_shard is None:
                part.fail("the config's mesh did not reach the FeatureExtractor")
            return runner, runner.launch_val_look_twice()

        runner, metrics = part.drive("eval", run)
        fe = runner.feature_extractor
        part.result["crops"] = runner.evaluator.crops
        part.expect("eval", _eval_launches(runner))
        part.result["MAE"] = _finite(part, "MAE", metrics["MAE"])
        part.result["SMeasure"] = _finite(part, "S-measure", metrics["SMeasure"])
        got = part.drive("tp extract", lambda: torch.from_numpy(fe.extract(pixels)))
        part.expect("tp extract", {"K1": (fe.config.num_layers - 1) * 2 * len(_data_slices(fe.mesh, len(pixels)))})
        if cuda:
            px = _t(pixels, device)
            with _full_f32(), torch.inference_mode():
                ref = dino_forward(fe.float32_params(), px, fe.config, compute_dtype=torch.float32,
                                   plain=True)["key_features"]
                low = dino_forward(fe.params, px, fe.config, compute_dtype=fe.compute_dtype,
                                   plain=True)["key_features"]
        else:
            plain = FeatureExtractor(cfg.dataset_cfg.feature_extractor_cfg, device=device,
                                     compute_dtype=torch.float32)
            plain.params = fe.float32_params()
            ref, low = torch.from_numpy(plain.extract(pixels)), None
        part.result.update(_close(part, "TP extract", got, ref, low, **FWD_TOL))
    return part.close()


def _eval_launches(runner) -> Dict[str, int]:
    """The kernels' launches of part 4's eval: the cache build's TP forwards
    (K1 per model shard, non-last layer and data coordinate of each batch;
    a batch the data axis does not divide runs once), then LookTwice's crop
    passes, each an unsharded forward (K6 and K1 per non-last layer)."""
    fe, ds = runner.feature_extractor, runner.val_dataset
    layers, bs = fe.config.num_layers - 1, ds.cache_build_batch
    coords = sum(len(_data_slices(fe.mesh, min(bs, len(ds) - s))) for s in range(0, len(ds), bs))
    crops = runner.evaluator.crop_batches * layers
    want = {"K1": coords * layers * fe.mesh.shape["model"] + crops}
    if crops:
        want["K6"] = crops
    return want


def lora_step(state, lora, backbone: Dict[str, Any], pixels: np.ndarray, plabels: np.ndarray, device,
              number: int = 5) -> Dict[str, Any]:
    """Part 5: one LoRA joint step (rank 2, alpha 4, remat on) of ``state``
    and ``lora`` in place, the global batch on ``device``."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step, make_optimizer

    device = torch.device(device)
    part = _Part(number, device)
    cfg = lora_cfg()
    dtype, masters = _lora_backbone(backbone, device)
    lora_opt = make_optimizer(tree_leaves(lora), 1e-4, 0.95, 25)
    step = make_lora_train_step(cfg, BACKBONE, dtype)
    px, pl = _t(pixels, device), _t(plabels, device)
    aux = part.drive("lora step", lambda: step(state, lora, lora_opt, masters, px, pl, 0.0, 1.0))
    layers = BACKBONE.num_layers - 1
    part.expect("lora step", {"K2": 2 * layers, "K3/K4": layers})  # remat re-runs the forward
    part.result["loss"] = _finite(part, "LoRA loss", float(aux["loss"]))
    part.result["lora_grad_norm"] = float(aux["lora_grad_norm"])
    if not part.result["lora_grad_norm"] > 0.0:
        part.fail("the adapters received no gradient")
    return part.close()


def _lora_backbone(params: Dict[str, Any], device: torch.device):
    """(compute dtype, backbone params) of a LoRA step on ``device``: on the
    card bf16 with float32 q/k/v masters (the adapters merge into them), on
    the CPU float32."""
    f32 = tree_map(lambda t: t.to(device), params)
    if device.type == "cuda":
        return torch.bfloat16, cast_params(f32, torch.bfloat16, qkv_masters=True)
    return torch.float32, f32


def sp_parts(state, lora, params: Dict[str, Any], n_devices: int, pixels: np.ndarray, step_pixels: np.ndarray,
             plabels: np.ndarray, device, number: int = 6) -> Dict[str, Any]:
    """Part 6: the sequence-parallel forward over ``{"data": n/4, "seq": 4}``
    against unsharded, then the SP LoRA step (in place) with its loss
    against the unsharded step's on the same state."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_train_step, make_optimizer
    from ucod_dpl_tpu_torch.parallel.sp import sp_param_grid

    device = torch.device(device)
    part = _Part(number, device)
    sp = 4 if n_devices % 4 == 0 else 2
    mesh = build_mesh({"data": n_devices // sp, "seq": sp}, devices=[device] * n_devices)
    part.result["mesh"] = dict(mesh.shape)
    f32, low = _backbones(params, device)
    dtype, masters = _lora_backbone(params, device)
    slices = _data_slices(mesh, pixels.shape[0])

    def forward():
        with torch.inference_mode():
            return torch.cat([dino_forward(sp_param_grid(low, mesh, "seq", data=d), _t(pixels[sl], device), BACKBONE,
                                           compute_dtype=dtype, sp_shard=(mesh, "seq"))["key_features"]
                              for d, sl in enumerate(slices)])

    kf = part.drive("sp forward", forward)
    pairs = _ring_pairs(_tokens(BACKBONE), sp) * (BACKBONE.num_layers - 1)
    part.expect("sp forward", {"K2": pairs * len(slices)})
    part.result["forward"] = _close(part, "SP key features", kf, *_references(params, pixels, device), **FWD_TOL)

    # the step: its loss against the unsharded step's loss on the same state
    cfg = lora_cfg()
    cuda = device.type == "cuda"
    px, pl = _t(step_pixels, device), _t(plabels, device)
    with torch.no_grad(), _full_f32():
        ref = float(make_lora_train_step(cfg, BACKBONE, torch.float32, plain=True).loss_fn(
            state, lora, f32, px, pl, 0.0, 1.0)[0])
        ref_low = float(make_lora_train_step(cfg, BACKBONE, torch.bfloat16, plain=True).loss_fn(
            state, lora, masters, px, pl, 0.0, 1.0)[0]) if cuda else None
    lora_opt = make_optimizer(tree_leaves(lora), 1e-4, 0.95, 25)
    step = make_lora_train_step(cfg, BACKBONE, dtype, sp_shard=(mesh, "seq"))
    aux = part.drive("sp lora step", lambda: step(state, lora, lora_opt, masters, px, pl, 0.0, 1.0))
    part.expect("sp lora step", {"K2": 2 * pairs, "K3/K4": pairs})
    part.result["loss"] = _finite(part, "SP LoRA loss", float(aux["loss"]))
    part.result["unsharded_loss"] = ref
    part.result["step"] = _loss_close(part, "SP LoRA step loss", part.result["loss"], ref, ref_low)
    part.result["lora_grad_norm"] = float(aux["lora_grad_norm"])
    if not part.result["lora_grad_norm"] > 0.0:
        part.fail("SP LoRA step: the adapters received no gradient through the ring")
    return part.close()


def sp_tp_forward(params: Dict[str, Any], n_devices: int, pixels: np.ndarray, device,
                  number: int = 7) -> Dict[str, Any]:
    """Part 7: the 2D forward over ``{"data": n/4, "model": 2, "seq": 2}``
    (heads over ``model``, tokens ringing over ``seq``) against unsharded."""
    from ucod_dpl_tpu_torch.parallel.sp import sp_param_grid

    device = torch.device(device)
    part = _Part(number, device)
    mesh = build_mesh({"data": n_devices // 4, "model": 2, "seq": 2}, devices=[device] * n_devices)
    _, low = _backbones(params, device)
    dtype = low["layers"][0]["fc1"]["w"].dtype
    slices = _data_slices(mesh, pixels.shape[0])

    def forward():
        with torch.inference_mode():
            return torch.cat([dino_forward(sp_param_grid(low, mesh, "seq", "model", data=d), _t(pixels[sl], device),
                                           BACKBONE, compute_dtype=dtype, sp_shard=(mesh, "seq"),
                                           tp_shard=(mesh, "model"))["key_features"] for d, sl in enumerate(slices)])

    kf = part.drive("2d forward", forward)
    pairs = _ring_pairs(_tokens(BACKBONE), 2, model=2) * (BACKBONE.num_layers - 1)
    part.expect("2d forward", {"K2": pairs * len(slices)})
    part.result.update(_close(part, "2D key features", kf, *_references(params, pixels, device), **FWD_TOL))
    return part.close()


# -- part 8: the LoRA step on a mesh over processes ------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _process_step(spec: Dict[str, Any], mesh, device: torch.device) -> Dict[str, Any]:
    """One SP LoRA step of the spec's trees on ``mesh``: the loss, LoRA
    gradient norm, launches and the flat stepped state."""
    from ucod_dpl_tpu_torch.engine.train_step import init_train_state, make_lora_train_step, make_optimizer

    cfg = lora_cfg()
    state = init_train_state(*spec["trees"], cfg.train_cfg, device)
    lora = tree_map(lambda t: t.to(device).clone().requires_grad_(True), spec["lora"])
    dtype, backbone = _lora_backbone(spec["backbone"], device)
    lora_opt = make_optimizer(tree_leaves(lora), 1e-4, 0.95, 25)
    step = make_lora_train_step(cfg, BACKBONE, dtype, sp_shard=(mesh, "seq"))
    px, pl = _t(spec["pixels"], device), _t(spec["plabels"], device)
    _sync(device)
    ops.reset_launches()
    aux = step(state, lora, lora_opt, backbone, px, pl, 0.0, 1.0)
    _sync(device)
    flat = torch.cat([t.detach().reshape(-1).float().cpu() for t in tree_leaves(state.decoder) + tree_leaves(lora)])
    return {"loss": float(aux["loss"]), "lora_grad_norm": float(aux["lora_grad_norm"]),
            "launches": {k: v for k, v in ops.launches().items() if v}, "state": flat}


def _rank_worker(spec_path: str) -> int:
    """One rank of part 8: the step on the ``{"seq": world}`` mesh over the
    processes; its results to ``<out>/rank<r>.pt``."""
    from ucod_dpl_tpu_torch.parallel import distributed as D

    spec = torch.load(spec_path, weights_only=False)
    device = D.maybe_initialize_distributed(spec["device"])
    rank = D.process_index()
    res = _process_step(spec, build_mesh({"seq": D.process_count()}), device)
    res["device"] = str(device)
    torch.save(res, os.path.join(spec["out"], f"rank{rank}.pt"))
    D.barrier("dryrun part 8")
    D.shutdown()
    return 0


def lora_over_processes(processes: int, device, trees, lora, backbone: Dict[str, Any], pixels: np.ndarray,
                        plabels: np.ndarray, timeout: float = 600.0, number: int = 8) -> Dict[str, Any]:
    """Part 8: the LoRA step on a ``{"seq": P}`` mesh over P processes (this
    module as ``--rank-worker``; gloo on the CPU, NCCL with rank r on
    ``cuda:r``), against the one-process ring's step over ``device`` named P
    times on the same trees: the ranks' stepped states equal bit for bit,
    their loss at rtol 1e-5 and LoRA gradient norm at 1e-4 of the
    one-process step's, and on the card the ring's K2 and K3/K4 launches in
    every rank."""
    device = torch.device(device)
    part = _Part(number, device)
    if device.type == "cuda" and torch.cuda.device_count() < processes:
        part.fail(f"{processes} processes need {processes} cards (NCCL takes one card per rank); "
                  f"{torch.cuda.device_count()} visible")
    cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    spec = {"trees": [cpu(t) for t in trees], "lora": cpu(lora), "backbone": cpu(backbone), "pixels": pixels,
            "plabels": plabels, "device": device.type}
    with tempfile.TemporaryDirectory(prefix="ucod_dryrun_ranks_") as out:
        spec["out"] = out
        spec_path = os.path.join(out, "spec.pt")
        torch.save(spec, spec_path)
        env = child_env(OMP_NUM_THREADS="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                        WORLD_SIZE=str(processes))
        procs = []
        try:
            for r in range(processes):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ucod_dpl_tpu_torch.tools.dryrun_multichip", "--rank-worker", spec_path],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}))
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:  # never leave a rank behind
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                part.fail(f"rank {r} exited {p.returncode}:\n{log[-4000:]}")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(processes)]
    one = _process_step(spec, build_mesh({"seq": processes}, devices=[device] * processes), device)
    for r, res in enumerate(ranks):
        if not torch.equal(res["state"], ranks[0]["state"]):
            part.fail(f"rank {r}'s stepped state differs from rank 0's")
        _loss_close(part, f"rank {r} loss against the one-process ring's", res["loss"], one["loss"], None)
        _close(part, f"rank {r} LoRA gradient norm", torch.tensor([res["lora_grad_norm"]]),
               torch.tensor([one["lora_grad_norm"]]), None, rtol=GRAD_NORM_RTOL, atol=0.0)
        if device.type == "cuda":
            pairs = _ring_pairs(_tokens(BACKBONE), processes) // processes * (BACKBONE.num_layers - 1)
            want = {"K2": 2 * pairs, "K3/K4": pairs}
            if res["launches"] != want:
                part.fail(f"rank {r} launches {res['launches']}, expected {want}")
    part.result.update({"processes": processes, "loss": [r["loss"] for r in ranks], "one_process_loss": one["loss"],
                        "lora_grad_norm": [r["lora_grad_norm"] for r in ranks],
                        "rank_devices": [r["device"] for r in ranks]})
    part.result["launches"] = {f"rank {r}": res["launches"] for r, res in enumerate(ranks)}
    return part.close()


# -- the dry run ---------------------------------------------------------------------------------------


def init_world() -> Dict[str, Any]:
    """The port's seeded trees of every part (on the CPU, float32):
    decoder towers, discriminator, backbone, refiner and adapters."""
    from ucod_dpl_tpu_torch.models.lora import init_lora
    from ucod_dpl_tpu_torch.models.udlr import init_sparse_refiner

    backbone = init_dino(1, BACKBONE)
    dis_p, dis_s = init_discriminator(2, feature_size=FEATURE_SIZE, feature_dim=DIM, use_features=False)
    return {"decoder": init_rev_decoder(0, DIM), "decoder_ema": init_rev_decoder(3, DIM),
            "dis_params": dis_p, "dis_stats": dis_s, "backbone": backbone,
            "refiner": init_sparse_refiner(5, DIM), "lora": init_lora(7, backbone, rank=LORA["rank"])}


def dryrun_multichip(n_devices: int = 8, device="cuda", processes: int = 0,
                     log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run the parts (see the module docstring) on ``device`` (the card
    unless the caller passes ``"cpu"``) named ``n_devices`` times; part 8
    when ``processes`` > 0.  Raises on the first
    failure; returns each part's checked numbers, launches and seconds, and
    prints one summary line through ``log``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: device cuda requested but CUDA is not available; pass device='cpu'")
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = build_mesh({"data": n_devices // tp, "model": tp}, devices=[device] * n_devices)
    w, x = init_world(), dryrun_inputs(n_devices)
    parts: Dict[str, Any] = {"mesh": dict(mesh.shape)}
    parts["1"], state = stage1_steps(w["decoder"], w["decoder_ema"], w["dis_params"], w["dis_stats"], x["features"],
                                     x["plabels"], device)
    if tp > 1:
        parts["2"] = tp_forward(mesh, w["backbone"], x["tp_pixels"])
    parts["3"] = refiner_step(w["refiner"], state.decoder, x["l_features"], x["h_features"], x["preds"], device)
    if tp > 1:
        parts["4"] = runner_tp_eval(n_devices, device, x["runner_pixels"])
    lora = tree_map(lambda t: t.to(device).requires_grad_(True), w["lora"])
    parts["5"] = lora_step(state, lora, w["backbone"], x["lora_pixels"], x["plabels"], device)
    if tp > 1:
        parts["6"] = sp_parts(state, lora, w["backbone"], n_devices, x["sp_pixels"], x["sp_step_pixels"],
                              x["plabels"], device)
    if n_devices % 8 == 0:
        parts["7"] = sp_tp_forward(w["backbone"], n_devices, x["pixels_2d"], device)
    if processes:
        parts["8"] = lora_over_processes(processes, device, [w[k] for k in ("decoder", "decoder_ema", "dis_params",
                                                                               "dis_stats")],
                                         w["lora"], w["backbone"], x["lora_pixels"], x["plabels"])
    log(summary(parts))
    return parts


def summary(parts: Dict[str, Any]) -> str:
    """The JAX function's summary line, for the parts that ran."""
    line = (f"dryrun_multichip OK: mesh={parts['mesh']} train loss={parts['1']['loss']:.4f} "
            f"refiner loss={parts['3']['loss']:.4f} lora loss={parts['5']['loss']:.4f}")
    if "2" in parts:
        line += f" tp-backbone key_features {parts['2']['key_features']} == unsharded"
    if "4" in parts:
        line += f" runner-path TP eval MAE={parts['4']['MAE']:.3f} (extract == unsharded)"
    if "6" in parts:
        line += (f" sp-backbone ring(seq={parts['6']['mesh']['seq']}) == unsharded + "
                 f"sp-lora-step(seq={parts['6']['mesh']['seq']}) == unsharded")
    if "7" in parts:
        line += " 2d-backbone(model=2 x seq=2) == unsharded"
    if "8" in parts:
        line += f" lora-step over {parts['8']['processes']} processes == one-process ring"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8, help="mesh size (default 8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--processes", type=int, default=0, help="part 8: the LoRA step over this many processes")
    ap.add_argument("--rank-worker", metavar="SPEC", help=argparse.SUPPRESS)  # one rank of part 8
    args = ap.parse_args(argv)
    if args.rank_worker:
        return _rank_worker(args.rank_worker)
    dryrun_multichip(args.n_devices, device=args.device, processes=args.processes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
