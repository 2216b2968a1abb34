"""The port's multi-device dry run (``ucod_dpl_tpu_torch.tools.dryrun_multichip``)
on the CPU, against the JAX package's ``__graft_entry__.py::dryrun_multichip``.

* The whole dry run on "cpu" named 8 times passes every part, parts 2, 6 and
  7 at the JAX function's tolerance against unsharded; with ``processes=2``
  part 8 runs the LoRA step over two gloo processes.
* Part 1's train and discriminator losses, part 3's refiner loss and part
  5's LoRA loss equal the JAX steps' on the same numpy inputs (the dry run's
  own, drawn in the JAX function's order) and the same weights, carried
  across by ``models/convert.py``: rtol 1e-5 (f32 steps), 1e-4 (the LoRA
  step).
* Teeth: one TP shard's attention output zeroed makes part 2 raise.
* The Runner's ``devices=`` hook builds ``tpu_cfg.mesh`` over the given
  devices and leaves the default alone.
* Part 4's expected launches on the card: the cache build's TP forwards and
  each LookTwice crop pass.
* The entry runs on the card unless the caller asks for the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.engine import train_step as JT
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu.models import udlr as JU
from ucod_dpl_tpu.models.dba import init_rev_decoder as j_init_decoder, rev_decoder_forward as j_decoder
from ucod_dpl_tpu.models.discriminator import init_discriminator as j_init_discriminator
from ucod_dpl_tpu_torch.engine.runner import Runner
from ucod_dpl_tpu_torch.engine.train_step import init_train_state
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.tools import dryrun_multichip as DR
from ucod_dpl_tpu_torch.tools.common import write_cod_set

JAX_BACKBONE = JD.DinoConfig(**{f: getattr(DR.BACKBONE, f) for f in DR.BACKBONE.__dataclass_fields__})
PARTS = ("1", "2", "3", "4", "5", "6", "7")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    return DR.dryrun_inputs(8)


@pytest.fixture(scope="module")
def jax_world():
    """The JAX function's trees (its keys), and their port copies."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    dec, ema = j_init_decoder(k1, DR.DIM), j_init_decoder(k2, DR.DIM)
    dis_p, dis_s = j_init_discriminator(k3, feature_size=DR.FEATURE_SIZE, feature_dim=DR.DIM, use_features=False)
    backbone = JD.init_dino(jax.random.PRNGKey(1), JAX_BACKBONE)
    refiner = JU.init_sparse_refiner(jax.random.PRNGKey(5), dim=DR.DIM, num_heads=8)
    lora = JL.init_lora(jax.random.PRNGKey(7), backbone, rank=2)
    port = {"trees": (C.decoder_from_jax(_np(dec)), C.decoder_from_jax(_np(ema)),
                      *C.discriminator_from_jax(_np(dis_p), _np(dis_s))),
            "backbone": C.dino_from_jax(_np(backbone)), "refiner": C.refiner_from_jax(_np(refiner)),
            "lora": C.lora_from_jax(_np(lora))}
    return dict(dec=dec, ema=ema, dis_p=dis_p, dis_s=dis_s, backbone=backbone, refiner=refiner, lora=lora), port


def _jax_state(w):
    opt, dis_opt = JT.make_optimizer(2e-4, 0.95, 25), JT.make_optimizer(1e-3, 0.95, 25)
    state = JT.TrainState(decoder=w["dec"], decoder_ema=w["ema"], opt_state=opt.init(w["dec"]),
                          dis_params=w["dis_p"], dis_stats=w["dis_s"], dis_opt_state=dis_opt.init(w["dis_p"]),
                          ema_step=jnp.zeros((), jnp.int32))
    return state, opt, dis_opt


@pytest.mark.parametrize("processes", [0, 2], ids=["one-process", "part8-two-processes"])
def test_dryrun_passes_every_part_on_the_cpu(processes):
    lines = []
    parts = DR.dryrun_multichip(8, device="cpu", processes=processes, log=lines.append)
    assert parts["mesh"] == {"data": 4, "model": 2}
    assert set(parts) == {"mesh", *PARTS, *(["8"] if processes else [])}
    assert lines == [DR.summary(parts)] and lines[0].startswith("dryrun_multichip OK: mesh={'data': 4, 'model': 2}")
    for key in ("loss", "dis_train_loss"):
        assert np.isfinite(parts["1"][key])
    assert parts["2"]["key_features"] == (8, 2, 2, 768)
    for checked in (parts["2"], parts["4"], parts["6"]["forward"], parts["7"]):
        assert checked["rtol"] == 2e-4 and checked["atol"] == 2e-5 and checked["max_abs_err"] < 1e-4
    assert np.isfinite(parts["3"]["loss"]) and np.isfinite(parts["4"]["MAE"]) and np.isfinite(parts["4"]["SMeasure"])
    assert parts["5"]["lora_grad_norm"] > 0 and parts["6"]["lora_grad_norm"] > 0
    assert parts["6"]["mesh"] == {"data": 2, "seq": 4}
    np.testing.assert_allclose(parts["6"]["loss"], parts["6"]["unsharded_loss"], rtol=1e-5)
    for p in PARTS:  # on the CPU the wrappers run their plain versions and launch nothing
        assert all(not v for v in parts[p]["launches"].values()) and parts[p]["seconds"] > 0
    if processes:
        p8 = parts["8"]
        assert p8["processes"] == 2 and p8["rank_devices"] == ["cpu", "cpu"]
        np.testing.assert_allclose(p8["loss"], [p8["one_process_loss"]] * 2, rtol=1e-5)
        assert all(n > 0 for n in p8["lora_grad_norm"])


def test_part1_losses_match_jax_steps(inputs, jax_world):
    w, port = jax_world
    state, opt, dis_opt = _jax_state(w)
    cfg = JCfg(DR.STAGE1)
    f, pl = jnp.asarray(inputs["features"]), jnp.asarray(inputs["plabels"])
    state, aux = jax.jit(JT.make_train_step(cfg, opt))(state, f, pl, jnp.float32(0.0), jnp.float32(1.0))
    _, dis_aux = jax.jit(JT.make_discriminator_step(cfg, dis_opt))(state, f, pl)
    got, _ = DR.stage1_steps(*port["trees"], inputs["features"], inputs["plabels"], "cpu")
    np.testing.assert_allclose(got["loss"], float(aux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["dis_train_loss"], float(dis_aux["dis_train_loss"]), rtol=1e-5)


def test_part3_refiner_loss_matches_jax(inputs, jax_world):
    w, port = jax_world
    refiner = {k: v for k, v in w["refiner"].items() if k != "num_heads"}
    lf, hf, pr = (jnp.asarray(inputs[k]) for k in ("l_features", "h_features", "preds"))
    ws, wl = DR.WINDOWS, DR.WINDOW_LENGTH

    def loss(rp):
        out = JU.sparse_refiner_forward(rp, lf, hf, pr, window_size=ws, threshold=0.0015)
        tgt, _, _ = j_decoder(w["dec"], hf.reshape(-1, wl, wl, DR.DIM), with_loss=False)
        return JU.refiner_distillation_loss(out, pr, (jax.nn.sigmoid(tgt) > 0.5).astype(jnp.float32), window_size=ws)

    want = float(jax.jit(loss)(refiner))
    got = DR.refiner_step(port["refiner"], port["trees"][0], inputs["l_features"], inputs["h_features"],
                          inputs["preds"], "cpu")
    np.testing.assert_allclose(got["loss"], want, rtol=1e-5)


def test_part5_lora_loss_matches_jax(inputs, jax_world, monkeypatch):
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")  # the JAX kernels as its own CPU tests run them
    w, port = jax_world
    state, opt, _ = _jax_state(w)
    lora_opt = JT.make_optimizer(1e-4, 0.95, 25)
    step = jax.jit(JT.make_lora_train_step(DR.lora_cfg(), opt, lora_opt, JAX_BACKBONE, jnp.float32))
    *_, aux = step(state, w["lora"], lora_opt.init(w["lora"]), w["backbone"], jnp.asarray(inputs["lora_pixels"]),
                   jnp.asarray(inputs["plabels"]), jnp.float32(0.0), jnp.float32(1.0))
    tstate = init_train_state(*port["trees"], DR.lora_cfg().train_cfg, "cpu")
    lora = C.tree_map(lambda t: t.clone().requires_grad_(True), port["lora"])
    got = DR.lora_step(tstate, lora, port["backbone"], inputs["lora_pixels"], inputs["plabels"], "cpu")
    np.testing.assert_allclose(got["loss"], float(aux["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["lora_grad_norm"], float(aux["lora_grad_norm"]), rtol=1e-3)


def test_zeroed_tp_shard_fails_part2(monkeypatch):
    """Teeth: the dry run catches one tensor-parallel shard whose attention
    output is lost."""
    from ucod_dpl_tpu_torch.models import dino

    real = dino.tp_multi_head_attention

    def broken(*args, **kwargs):
        outs = real(*args, **kwargs)
        return [outs[0], torch.zeros_like(outs[1]), *outs[2:]]

    monkeypatch.setattr(dino, "tp_multi_head_attention", broken)
    with pytest.raises(AssertionError, match=r"^part 2 \(TP key features\) against unsharded"):
        DR.dryrun_multichip(8, device="cpu", log=lambda _: None)


def test_runner_devices_hook(tmp_path):
    """``Runner(devices=)`` builds ``tpu_cfg.mesh`` over the given devices
    (one named four times reaches a TP extractor); without it a CPU run's
    mesh is the one device, as before, and a 4-device mesh raises."""
    write_cod_set(str(tmp_path / "RefCOD" / "TINY"), 3, "rect")
    cfg = DR.runner_cfg(str(tmp_path), {"data": 2, "model": 2}, 64)
    cfg.tpu_cfg.compute_dtype = "float32"
    runner = Runner(cfg, mode="eval", device="cpu", devices=["cpu"] * 4)
    assert runner.mesh.shape == {"data": 2, "model": 2} and runner.feature_extractor.tp_shard is not None
    assert [str(d) for d in runner.mesh.devices.flat] == ["cpu"] * 4
    with pytest.raises(ValueError, match="do not divide the device count 1"):
        Runner(cfg, mode="eval", device="cpu")
    cfg.tpu_cfg.mesh = {"data": -1, "model": 1}
    assert Runner(cfg, mode="eval", device="cpu").mesh.shape == {"data": 1, "model": 1}


def test_part4_expected_launches(tmp_path):
    """Part 4 holds its eval to an exact count: 3 images in one cache batch
    that the data axis of 4 does not divide run once, K1 on each of 2 model
    shards for the one non-last layer; each crop pass adds one unsharded
    forward (K6 and K1)."""
    from types import SimpleNamespace

    write_cod_set(str(tmp_path / "RefCOD" / "TINY"), 3, "rect")
    cfg = DR.runner_cfg(str(tmp_path), {"data": 4, "model": 2}, 64)
    cfg.tpu_cfg.compute_dtype = "float32"
    runner = Runner(cfg, mode="eval", device="cpu", devices=["cpu"] * 8)
    runner.evaluator = SimpleNamespace(crop_batches=0)
    assert DR._eval_launches(runner) == {"K1": 2}
    runner.evaluator.crop_batches = 3
    assert DR._eval_launches(runner) == {"K1": 5, "K6": 3}


def test_dryrun_defaults_to_the_card():
    import inspect

    assert inspect.signature(DR.dryrun_multichip).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DR.dryrun_multichip()
