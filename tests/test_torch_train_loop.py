"""The port's stage-1 training entry on the CPU against the JAX package.

``TrainLoop`` against the JAX ``TrainLoop`` over 5 epochs on the fixture of
tests/test_trainloop_equivalence.py (DIM 32, feature size 8, batch 2, 4
batches an epoch, finetune from epoch 3, discriminator inter-training at
epochs 0 and 2, StepLR decaying every 3 batches; confident decoder heads and
pseudo-labels at {0.2, 0.9}, so no float noise crosses a 0.5 threshold),
with the same weights carried across by ``ucod_dpl_tpu_torch.models.convert``
and the same numpy batches.  Tolerances are the JAX package's own against
the reference loop (test_trainloop_equivalence.py:360-417): every loss
within rtol 5e-5 / atol 2e-5, the final decoder, EMA teacher and
discriminator within rtol 1e-4 / atol 5e-6, and the learnable embedding
(whose gradient is the orthogonality term's near-zero reduction noise,
which AdamW turns into steps of up to lr either way) by its median and
maximum drift.  Also: ``Runner(mode="train")`` against the JAX Runner (train
order, pseudo-labels, pixels), the LoRA branch for 2 epochs against the JAX
package with its Pallas kernels in interpret mode, ``cli train --device
cpu`` end to end, and the entry's errors.
"""

import dataclasses
import hashlib
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor as JFeatureExtractor
from ucod_dpl_tpu.engine import Runner as JRunner
from ucod_dpl_tpu.engine import preempt as JP
from ucod_dpl_tpu.engine.train_loop import TrainLoop as JLoop
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu.models.dba import init_rev_decoder as j_init_decoder
from ucod_dpl_tpu.models.discriminator import init_discriminator as j_init_discriminator
from ucod_dpl_tpu.parallel import build_mesh as j_build_mesh
from ucod_dpl_tpu_torch import cli as TCLI
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor as TFeatureExtractor
from ucod_dpl_tpu_torch.engine import checkpoint as TCK
from ucod_dpl_tpu_torch.engine import preempt as TP
from ucod_dpl_tpu_torch.engine.runner import Runner as TRunner
from ucod_dpl_tpu_torch.engine.train_loop import TrainLoop as TLoop
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.models import lora as TL
from ucod_dpl_tpu_torch.parallel.mesh import build_mesh
from ucod_dpl_tpu_torch.utils.fileio import ArrayCache

from test_torch_dinov1 import on_dinov1
from test_torch_eval import _make_dataset

DIM = 32
FS = 8
B = 2
NB = 4
LR0 = 2e-4


def train_cfg_dict(**train):
    """tests/test_trainloop_equivalence.py's configuration, ``train``
    overriding keys of its ``train_cfg``."""
    tc = {"start_epoch": 0, "max_epoch": 5, "start_finetune": -2, "merge_method": "dis", "merge_alpha": 0.5,
          "dis_intertrain": 2, "dis_epoch": 1, "lr0": LR0, "dis_lr0": 1e-3, "step_lr_size": 3, "step_lr_gamma": 0.9,
          "dis_step_lr_size": 3, "dis_step_lr_gamma": 0.9,
          "save_cfg": {"start_save": 10_000, "save_interval": 5, "save_mode": "model"}}
    tc.update(train)
    return {"seed": 42, "model_cfg": {"dim": DIM, "feature_size": FS, "ema_weight": 0.99, "dis_use_features": True},
            "train_cfg": tc, "val_cfg": {"enable_val": False, "val_interval": 5, "start_val": 10_000},
            "log_cfg": {"log_interval": 1_000}}


def make_batches(seed=0, n=NB):
    """Features ~N(0, 1) on a 6x6 grid, pseudo-labels at {0.2, 0.9}."""
    rng = np.random.default_rng(seed)
    return [{"features": rng.standard_normal((B, 6, 6, DIM)).astype(np.float32),
             "pseudo_label": np.where(rng.random((B, 16, 16, 1)) > 0.5, 0.9, 0.2).astype(np.float32)}
            for _ in range(n)]


def confident_decoder(seed):
    """A JAX decoder with boosted heads, pushing sigmoid outputs away from
    0.5 (tests/ref_pipeline_harness.py::confident_decoder_params)."""
    p = j_init_decoder(jax.random.PRNGKey(seed), DIM)
    return p._replace(conv_out_fg_w=p.conv_out_fg_w * 4.0, conv_out_bg_w=p.conv_out_bg_w * 4.0,
                      conv_out_fg_b=p.conv_out_fg_b + jnp.float32(0.1),
                      conv_out_bg_b=p.conv_out_bg_b - jnp.float32(0.1))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shared_weights():
    """(decoder, EMA, discriminator params, stats) as numpy trees in the JAX
    layout (the JAX loop donates the arrays it is given)."""
    dis_p, dis_s = j_init_discriminator(jax.random.PRNGKey(3), feature_size=FS, feature_dim=DIM, use_features=True)
    return np_tree((confident_decoder(0), confident_decoder(1), dis_p, dis_s))


class Loader:
    """A fixed-order loader with the set_epoch/skip_batches surface the
    loops use (the reference fixture's plain list iteration)."""

    def __init__(self, batches):
        self.batches = batches
        self._skip = 0

    def set_epoch(self, epoch):
        pass

    def skip_batches(self, n):
        self._skip = n

    def __iter__(self):
        s, self._skip = self._skip, 0
        return iter(self.batches[s:])

    def __len__(self):
        return len(self.batches)


class Logger:
    def log(self, *a, **k):
        pass

    def log_table(self, *a, **k):
        pass

    error = warning = log


class JaxRunner:
    """What the JAX TrainLoop reads of a Runner."""

    def __init__(self, weights, batches, ckp_dir, fe=None):
        self.mesh = j_build_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
        (self.decoder_params, self.decoder_ema_params, self.discriminator_params,
         self.discriminator_stats) = weights
        self.train_dataloader = Loader(batches)
        self.ckp_dir = str(ckp_dir)
        self.feature_extractor = fe
        self.logger = Logger()

    def save_checkpoint(self, epoch):
        pass

    def launch_val_look_twice(self):
        return {"MAE": 0.5}


class PortRunner:
    """The same for the port's TrainLoop, on the CPU."""

    def __init__(self, weights, batches, ckp_dir, fe=None, mesh=None):
        dec, ema, dis_p, dis_s = np_tree(weights)
        self.mesh = mesh or build_mesh({"data": 1, "model": 1}, devices=["cpu"])
        self.device = torch.device("cpu")
        self.decoder_params, self.decoder_ema_params = C.decoder_from_jax(dec), C.decoder_from_jax(ema)
        self.discriminator_params, self.discriminator_stats = C.discriminator_from_jax(dis_p, dis_s)
        self.train_dataloader = Loader(batches)
        self.ckp_dir = str(ckp_dir)
        self.feature_extractor = fe
        self.logger = Logger()

    def save_checkpoint(self, epoch):
        pass

    def launch_val_look_twice(self):
        return {"MAE": 0.5}


def run_loop(loop):
    """``loop.run()`` recording every decoder step's loss, with the
    preemption flag and signal handlers left as they were."""
    losses = []
    orig = loop._train_step

    def recording(*a, **k):
        out = orig(*a, **k)
        aux = out[1] if isinstance(out, tuple) else out
        losses.append(float(aux["loss"]))
        return out

    loop._train_step = recording
    try:
        loop.run()
    finally:
        JP.clear()
        TP.clear()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
    return losses


def assert_state_close(port_state, jax_state, what=""):
    """Port TrainState against a JAX TrainState at the JAX package's
    tolerances against the reference loop."""
    got, want = C.train_state_to_jax(port_state), np_tree(jax_state)
    for tower in ("decoder", "decoder_ema"):
        for f in want.decoder._fields:
            a, b = got[tower][f], np.asarray(getattr(getattr(want, tower), f))
            if f == "learnable_embedding":
                d = np.abs(a - b)
                assert np.median(d) < 5e-5 and d.max() < 2.5e-3, (what, tower, np.median(d), d.max())
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-6, err_msg=f"{what} {tower}.{f}")
    got_dis = C.discriminator_to_jax(*C.discriminator_from_jax(want.dis_params, want.dis_stats))[0]
    for key in ("dis_params", "dis_stats"):
        flat_g = TCK.flatten_with_paths(got[key])
        flat_w = TCK.flatten_with_paths(got_dis if key == "dis_params" else np_tree(want.dis_stats))
        assert set(flat_g) == set(flat_w)
        for k in flat_g:
            np.testing.assert_allclose(flat_g[k], flat_w[k], rtol=1e-4, atol=5e-6, err_msg=f"{what} {key}/{k}")
    assert int(got["ema_step"]) == int(want.ema_step)
    for key in ("opt_state", "dis_opt_state"):
        assert int(got[key][0]["count"]) == int(getattr(want, key)[0].count)
        assert int(got[key][2]["count"]) == int(getattr(want, key)[2].count)


def write_pseudo_labels(cache_dir, dataset_dir, name, shape=(4, 4, 1), seed=0):
    """A seeded pseudo-label cache in the JAX generator's layout and identity
    sidecar (ucod_dpl_tpu/cli.py:264-292): one entry per image of ``name``
    (``+``-joined directories, sorted paths)."""
    paths = sorted(p for ds in name.split("+") for p in (dataset_dir / ds / "im").iterdir())
    cache = ArrayCache(os.path.join(str(cache_dir), "pseudo_label_cache", name))
    rng = np.random.default_rng(seed)
    for i in range(len(paths)):
        cache.write(i, np.where(rng.random(shape) > 0.5, 0.9, 0.2).astype(np.float32))
    stems = "\n".join(p.stem for p in paths)
    cache.flush(meta={"n": len(paths), "fingerprint": hashlib.sha1(stems.encode()).hexdigest(), "th_bkg": 0.6})


# ---------------------------------------------------------------------------
# the loop against the JAX package's
# ---------------------------------------------------------------------------


def test_train_loop_matches_jax_over_5_epochs(tmp_path):
    """20 decoder steps across two discriminator passes, the StepLR decay,
    the APM ramp and the finetune switch (fresh optimizers, APM off, EMA
    ramp reset): every loss, the final trees and the step counts."""
    weights, batches = shared_weights(), make_batches()
    jl = JLoop(JCfg(train_cfg_dict()), JaxRunner(weights, batches, tmp_path / "j"))
    want = run_loop(jl)
    tl = TLoop(TCfg(train_cfg_dict()), PortRunner(weights, batches, tmp_path / "t"))
    got = run_loop(tl)
    assert len(got) == len(want) == 5 * NB
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=2e-5, err_msg="per-step losses")
    assert tl.finetune and jl.finetune
    assert_state_close(tl.state, jl.state)
    # the finetune switch rebuilt the optimizers: 2 epochs of steps since
    assert tl.state.opt.count == 2 * NB and tl.state.opt.schedule.last_epoch == 2 * NB
    assert tl.state.opt.adamw.param_groups[0]["lr"] == pytest.approx(LR0 * 0.9 ** (2 * NB // 3))


def test_finetune_switch_restarts_the_optimizers_on_the_same_tensors(tmp_path):
    """``_enter_finetune``: new AdamW and StepLR over the very tensors the
    step updates (the rate back at lr0, no moments, count 0), ``ema_step``
    0, the discriminator's optimizer likewise."""
    weights, batches = shared_weights(), make_batches()
    tl = TLoop(TCfg(train_cfg_dict(max_epoch=2, start_finetune=-1)), PortRunner(weights, batches, tmp_path))
    run_loop(tl)  # epoch 1 is the finetune epoch: 4 steps on the fresh optimizers
    assert tl.state.opt.count == NB and tl.state.ema_step == 2 * NB
    old_opt, old_dis = tl.state.opt, tl.state.dis_opt
    tl._enter_finetune()
    for new, old, tree in ((tl.state.opt, old_opt, tl.state.decoder), (tl.state.dis_opt, old_dis, tl.state.dis_params)):
        assert new is not old and new.count == 0 and new.schedule.last_epoch == 0
        assert all(a is b for a, b in zip(new.params, C.tree_leaves(tree), strict=True))
        assert new.adamw.param_groups[0]["lr"] == old.schedule.base_lrs[0]
    assert tl.state.ema_step == 0


def test_runner_train_mode_matches_jax(tmp_path, variant="dinov2"):
    """``Runner(mode="train")`` on a ``+``-joined dataset with the tiny
    2-layer backbone of tests/test_torch_eval.py (or its DINOv1 twin): the
    same train order, the same pseudo-labels and pixels (LoRA on:
    ``require_pixels``) and features within the float32 forward tolerance,
    against the JAX Runner, for a train epoch and a discriminator pass's
    order."""
    from test_torch_eval import ARCHS, _cfg_dict

    root = tmp_path
    for name, n in (("A", 3), ("B", 4)):
        _make_dataset(root / "RefCOD", name=name, n=n)
    weights = root / "hf"
    weights.mkdir()
    dcfg = dataclasses.replace(TD.DinoConfig.from_type(variant), **ARCHS[variant])
    TD.save_hf_checkpoint(str(weights / "model.safetensors"), TD.init_dino(0, dcfg), dcfg)
    runners = {}
    for tag, cfg_cls, runner_cls, kw in (("jax", JCfg, JRunner, {}), ("port", TCfg, TRunner, {"device": "cpu"})):
        d = _cfg_dict(root, tag, weights, variant=variant)
        d["dataset_cfg"]["trainset_cfg"]["DATASET"] = "A+B"
        d["dataset_cfg"]["valset_cfg"]["DATASET"] = "A"
        d["dataset_cfg"]["trainloader_cfg"]["batch_size"] = 3
        d["model_cfg"]["lora"] = {"enable": True, "rank": 2, "alpha": 4.0}
        write_pseudo_labels(root / f"cache_{tag}", root / "RefCOD", "A+B", seed=1)
        runners[tag] = runner_cls(cfg_cls(d), mode="train", **kw)
    jr, tr = runners["jax"], runners["port"]
    assert tr.feature_extractor.params["layers"][0]["q"]["w"].dtype == torch.float32  # qkv masters
    assert len(tr.train_dataset) == len(jr.train_dataset) == 7
    assert len(tr.train_dataloader) == len(jr.train_dataloader) == 2  # drop_last
    for epoch in (0, 3, 1_000_000 + 2 * 100):
        jr.train_dataloader.set_epoch(epoch)
        tr.train_dataloader.set_epoch(epoch)
        jb, tb = list(jr.train_dataloader), list(tr.train_dataloader)
        assert len(jb) == len(tb) == 2
        for a, b in zip(jb, tb):
            assert a["img_path"] == b["img_path"]
            assert np.array_equal(a["pseudo_label"], b["pseudo_label"])
            np.testing.assert_allclose(b["pixels"], a["pixels"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(b["features"], a["features"], rtol=1e-5, atol=1e-5)
    orders = []
    for epoch in (0, 1):
        tr.train_dataloader.set_epoch(epoch)
        orders.append([p for b in tr.train_dataloader for p in b["img_path"]])
    assert orders[0] != orders[1]  # the order is a function of (seed, epoch)


test_runner_train_mode_matches_jax_on_dinov1 = on_dinov1(test_runner_train_mode_matches_jax)


# ---------------------------------------------------------------------------
# the LoRA branch
# ---------------------------------------------------------------------------


# two heads of 64; DINOv1's ViT-B/8 keeps its patch 8, eps 1e-12, no
# layerscale and 28 x 28 position grid (7 x 7 patches at 56px)
LORA_ARCH = {"hidden_size": 128, "num_layers": 2, "num_heads": 2, "patch_size": 14, "image_size": 56}
LORA_ARCHS = {"dinov2": LORA_ARCH, "dinov1": {"hidden_size": 128, "num_layers": 2, "num_heads": 2}}


def _lora_cfg_dict(tmp_path, **train):
    d = train_cfg_dict(max_epoch=2, start_finetune=-1, **train)
    d["model_cfg"] = {"dim": 128, "feature_size": FS, "ema_weight": 0.99, "dis_use_features": False,
                      "lora": {"enable": True, "rank": 2, "alpha": 4.0, "lr": 1e-4, "remat": "none"}}
    return d


def _lora_world(tmp_path, variant="dinov2"):
    """Both packages' extractors on one seeded HuggingFace checkpoint of a
    hidden-128 backbone of ``variant`` (two heads of 64: the JAX attention
    takes its Pallas kernel and flash VJP), float32; batches with pixels."""
    dcfg = dataclasses.replace(TD.DinoConfig.from_type(variant), **LORA_ARCHS[variant])
    path = tmp_path / "hf.safetensors"
    TD.save_hf_checkpoint(str(path), TD.init_dino(5, dcfg), dcfg)
    fe_cfg = {"type": variant, "backbone": "facebook/dinov2-base" if variant == "dinov2" else "facebook/dino-vitb8",
              "backbone_weights": str(path), "arch": dict(LORA_ARCHS[variant])}
    g = 56 // dcfg.patch_size
    jfe = JFeatureExtractor(JCfg(fe_cfg), compute_dtype=jnp.float32, strict=True)
    tfe = TFeatureExtractor(TCfg(fe_cfg), device="cpu", compute_dtype=torch.float32, strict=True, qkv_masters=True)
    rng = np.random.default_rng(7)
    batches = [{"pixels": rng.standard_normal((B, 56, 56, 3)).astype(np.float32),
                "pseudo_label": np.where(rng.random((B, 16, 16, 1)) > 0.5, 0.9, 0.2).astype(np.float32),
                "features": np.zeros((B, g, g, 128), np.float32)} for _ in range(2)]
    dec, ema = j_init_decoder(jax.random.PRNGKey(0), 128), j_init_decoder(jax.random.PRNGKey(1), 128)
    dis_p, dis_s = j_init_discriminator(jax.random.PRNGKey(3), feature_size=FS, feature_dim=128, use_features=False)
    return jfe, tfe, batches, np_tree((dec, ema, dis_p, dis_s))


def test_lora_branch_matches_jax_for_2_epochs(tmp_path, monkeypatch, variant="dinov2"):
    """Two epochs with LoRA on: a discriminator pass on the adapted
    backbone's features, 2 LoRA steps, the finetune switch (the adapters'
    optimizer restarts too), 2 more, and the epoch-2 saves.  Losses within
    rtol 5e-4 / atol 2e-5 and adapters within rtol 1e-4 / atol 1e-5 of the
    JAX package (its float32 tolerance for gradients through the backbone,
    tests/test_attention_vjp.py, and for adapters after AdamW steps,
    tests/test_torch_train.py); decoder and discriminator as in the cached
    loop.  The adapter and merged-backbone files load in the JAX package's
    loaders; a state pair from two saves is refused on resume."""
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    jfe, tfe, batches, weights = _lora_world(tmp_path, variant)
    cfg = _lora_cfg_dict(tmp_path, save_cfg={"start_save": 0, "save_interval": 2, "save_mode": "all"})
    jl = JLoop(JCfg(cfg), JaxRunner(weights, batches, tmp_path / "j", fe=jfe))
    tl = TLoop(TCfg(cfg), PortRunner(weights, batches, tmp_path / "t", fe=tfe))
    with torch.no_grad():  # the JAX package's seeded adapters, B moved off 0 so the A-grads are live
        rng = np.random.default_rng(9)
        jl.lora_params = [{t: {"a": e["a"], "b": jnp.asarray(0.05 * rng.standard_normal(e["b"].shape), jnp.float32)}
                           for t, e in layer.items()} for layer in jl.lora_params]
        jl.lora_opt_state = jl.lora_optimizer.init(jl.lora_params)
        for t, v in zip(C.tree_leaves(tl.lora_params),
                        C._leaves_like(tl.lora_params, C.lora_from_jax(np_tree(jl.lora_params))), strict=True):
            t.copy_(v)
    extracts = {"j": 0, "t": 0}
    for key, loop in (("j", jl), ("t", tl)):
        orig = loop._lora_extract

        def counting(*a, _orig=orig, _key=key):
            extracts[_key] += 1
            return _orig(*a)

        loop._lora_extract = counting
    lora_losses = {}
    for key, loop in (("j", jl), ("t", tl)):
        orig = loop._lora_step
        lora_losses[key] = []

        def recording(*a, _orig=orig, _key=key):
            out = _orig(*a)
            lora_losses[_key].append(float((out[3] if isinstance(out, tuple) else out)["loss"]))
            return out

        loop._lora_step = recording
    assert run_loop(jl) == run_loop(tl) == []  # LoRA on: no cached-feature step
    assert extracts == {"j": 2, "t": 2}  # the discriminator pass at epoch 0
    assert len(lora_losses["t"]) == 4
    np.testing.assert_allclose(lora_losses["t"], lora_losses["j"], rtol=5e-4, atol=2e-5, err_msg="LoRA losses")
    want = C.lora_from_jax(np_tree(jl.lora_params))
    for got_t, want_t in zip(C.tree_leaves(tl.lora_params), C._leaves_like(tl.lora_params, want), strict=True):
        np.testing.assert_allclose(got_t.detach().numpy(), want_t.numpy(), rtol=1e-4, atol=1e-5)
    assert any(e["b"].abs().sum() > 0 for layer in tl.lora_params for e in layer.values())
    assert tl.lora_opt.count == 2  # restarted at the finetune switch
    assert_state_close(tl.state, jl.state, "LoRA")

    # the epoch-2 files, read by the JAX package's loaders
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    adapters = JL.load_lora_checkpoint(str(tdir / "lora_epoch2.safetensors"))
    for a, b in zip(jax.tree_util.tree_leaves(adapters), jax.tree_util.tree_leaves(np_tree(jl.lora_params))):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4, atol=1e-5)
    merged_t = JD.load_hf_checkpoint(str(tdir / "backbone_merged_epoch2.safetensors"), jfe.config)
    merged_j = JD.load_hf_checkpoint(str(jdir / "backbone_merged_epoch2.safetensors"), jfe.config)
    for a, b in zip(jax.tree_util.tree_leaves(merged_t), jax.tree_util.tree_leaves(merged_j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert (tdir / "state_epoch2.npz").exists() and (tdir / "state_epoch2_lora.npz").exists()
    # the port resumes the JAX package's pair exactly ...
    resumed = TLoop(TCfg({**cfg, "train_cfg": {**cfg["train_cfg"], "resume": str(jdir / "state_epoch2")}}),
                    PortRunner(weights, batches, tmp_path / "r", fe=tfe))
    for got_t, want_t in zip(C.tree_leaves(resumed.lora_params), C._leaves_like(resumed.lora_params, want)):
        assert torch.equal(got_t.detach(), want_t)
    assert resumed.lora_opt.count == 2 and resumed.start_epoch == 2
    # ... and refuses a pair whose halves come from two saves
    pair, meta = TCK.load_train_state(str(tdir / "state_epoch2_lora"),
                                      C.lora_state_to_jax(tl.lora_params, tl.lora_opt))
    TCK.save_train_state(str(tdir / "state_epoch2_lora"), pair, {**meta, "epoch": 1})
    with pytest.raises(RuntimeError, match="different save"):
        TLoop(TCfg({**cfg, "train_cfg": {**cfg["train_cfg"], "resume": str(tdir / "state_epoch2")}}),
              PortRunner(weights, batches, tmp_path / "r2", fe=tfe))


test_lora_branch_matches_jax_for_2_epochs_on_dinov1 = on_dinov1(test_lora_branch_matches_jax_for_2_epochs)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


# per family: the shipped config, the backbone over it, the decoder width and
# the image size (DINOv1: ViT-B/8 at 128 wide in two heads of 64, 4 x 4
# patches at 32px)
TINY_TRAIN = {"dinov2": ("UCOD-DPL_dinov2.py", {"hidden_size": 32, "num_layers": 2, "num_heads": 2, "patch_size": 14,
                                                "image_size": 28}, 32, 28),
              "dinov1": ("UCOD-DPL_dinov1.py", {"hidden_size": 128, "num_layers": 2, "num_heads": 2}, 128, 32)}


def _tiny_train_config(root, train_cfg=None, variant="dinov2"):
    """A config file over configs/uscod/UCOD-DPL_dinov2.py (or _dinov1.py):
    a 2-layer 32-wide (128-wide) backbone and feature size 4 (``train_cfg``
    merged into its train_cfg)."""
    base, arch, dim, _ = TINY_TRAIN[variant]
    cfg = {"_BASE_": [os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "configs", "uscod", base)],
           "model_cfg": {"dim": dim, "feature_size": 4}, "train_cfg": train_cfg or {},
           "dataset_cfg": {"feature_extractor_cfg": {"arch": arch}}}
    path = root / "tiny_train.py"
    path.write_text(f"cfg = {cfg!r}\n")
    return path


def _train_argv(root, path, *extra, variant="dinov2"):
    size = str((TINY_TRAIN[variant][3],) * 2)
    return ["train", "-c", str(path), "--device", "cpu", "--work_dir", str(root / "wd"), *extra, "--opts",
            "dataset_cfg.dataset_dir", str(root / "RefCOD"), "dataset_cfg.cache_dir", str(root / "cache"),
            "dataset_cfg.trainset_cfg.DATASET", "TR-A+TR-B", "dataset_cfg.valset_cfg.DATASET", "TE-A",
            "dataset_cfg.trainset_cfg.image_size", size, "dataset_cfg.valset_cfg.image_size", size,
            "dataset_cfg.trainloader_cfg.batch_size", "2", "tpu_cfg.compute_dtype", "float32",
            "train_cfg.max_epoch", "2", "train_cfg.start_finetune", "-1", "train_cfg.dis_intertrain", "2",
            "train_cfg.save_cfg.save_mode", "all", "train_cfg.save_cfg.save_interval", "2",
            "train_cfg.save_cfg.start_save", "0", "val_cfg.val_interval", "2", "val_cfg.start_val", "2",
            "val_cfg.look_twice_th", "0.95"]


def _train_world(root, pseudo_labels=True):
    for name, n in (("TR-A", 3), ("TR-B", 3), ("TE-A", 2)):
        _make_dataset(root / "RefCOD", name=name, n=n)
    if pseudo_labels:
        write_pseudo_labels(root / "cache", root / "RefCOD", "TR-A+TR-B", shape=(2, 2, 1))


def test_cli_train_on_the_cpu_end_to_end_and_resume(tmp_path, variant="dinov2"):
    """``python3 -m ucod_dpl_tpu_torch.cli train --device cpu`` on a tiny
    config over the shipped one (of either family): 2 epochs of 3 steps,
    finite losses, moved parameters, the epoch-2 model and state files, a
    best result; then ``--resume state_epoch2`` is a run with nothing left
    to do, ending on the saved state."""
    _train_world(tmp_path)
    path = _tiny_train_config(tmp_path, variant=variant)
    runner = TCLI.train_main(_train_argv(tmp_path, path, variant=variant)[1:])
    assert runner.feature_extractor.config.variant == variant
    loop = runner.train_loop
    assert loop.state.opt.count == 3 and loop.state.ema_step == 6  # finetune at epoch 1: 3 steps since
    assert loop.best_result is not None and np.isfinite(loop.best_mae)
    ckp = runner.ckp_dir
    assert {"epoch2.safetensors", "state_epoch2.npz", "state_epoch2.json"} <= set(os.listdir(ckp))
    fresh = TRunner(runner.cfg, mode="train", device="cpu")
    assert all(not torch.equal(a, b) for a, b in zip(runner.decoder_params, fresh.decoder_params))
    assert all(torch.isfinite(t).all() for t in runner.decoder_params)
    resumed = TCLI.train_main(_train_argv(tmp_path, path, "--resume", os.path.join(ckp, "state_epoch2"),
                                          variant=variant)[1:])
    assert resumed.train_loop.start_epoch == 2 and resumed.train_loop.finetune
    for a, b in zip(resumed.decoder_params, runner.decoder_params):
        assert torch.equal(a, b)


test_cli_train_on_the_cpu_end_to_end_and_resume_on_dinov1 = on_dinov1(test_cli_train_on_the_cpu_end_to_end_and_resume)


@pytest.mark.parametrize("case", ["empty_loader", "no_pseudo_labels", "lora_model_parallel", "orbax"])
def test_train_entry_errors(tmp_path, case):
    """An empty train loader, a missing pseudo-label cache, LoRA with a
    model-parallel mesh and the orbax backend fail loudly, before a step."""
    _train_world(tmp_path, pseudo_labels=case != "no_pseudo_labels")
    path = _tiny_train_config(tmp_path, {"save_cfg": {"backend": "orbax"}} if case == "orbax" else None)
    argv = _train_argv(tmp_path, path)
    if case == "empty_loader":
        with pytest.raises(ValueError, match="Train dataloader is empty"):
            TCLI.main(argv + ["dataset_cfg.trainloader_cfg.batch_size", "7"])
    elif case == "no_pseudo_labels":
        with pytest.raises(RuntimeError, match="generate_pseudo_label first"):
            TCLI.main(argv)
    elif case == "lora_model_parallel":
        weights, batches = shared_weights(), make_batches()
        mesh = build_mesh({"data": 1, "model": 2}, devices=["cpu", "cpu"])
        cfg = TCfg(train_cfg_dict())
        cfg.model_cfg.lora = {"enable": True}
        with pytest.raises(NotImplementedError, match="model-parallel"):
            TLoop(cfg, PortRunner(weights, batches, tmp_path / "t", mesh=mesh))
    else:
        with pytest.raises(NotImplementedError, match="JAX library's format"):
            TCLI.main(argv)
