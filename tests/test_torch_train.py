"""The port's LoRA, discriminator and stage-1 training steps against the JAX
package.

The same initial trees (the JAX package's, carried across by
``ucod_dpl_tpu_torch.models.convert``) and the same numpy batches go through
both packages; the JAX side runs its Pallas kernels in interpret mode.  A
tiny DINOv2 (hidden 128, two heads of 64, three layers) keeps the JAX
attention on its kernel VJP.  Float32 tolerances: 5e-4 / 1e-5 for gradients
through the backbone (``tests/test_attention_vjp.py``), 1e-4 / 1e-5 for
parameters after three AdamW steps (see ``_assert_states_close`` for the one
leaf whose gradient is pure rounding noise).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.config import CfgNode
from ucod_dpl_tpu.engine import train_step as JT
from ucod_dpl_tpu.models import dba as JB
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import discriminator as JDis
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu.ops.resize import interpolate_bilinear as j_bilinear
from ucod_dpl_tpu_torch.engine import train_step as TT
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.models import discriminator as TDis
from ucod_dpl_tpu_torch.models import lora as TL
from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear

from test_torch_dinov1 import on_dinov1

DIM = 128
FS = 8


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny(request):
    """A family's geometry (dinov2, or the one an indirect parameter names:
    dinov1, ViT-B/8, has patch 8, no layerscale and eps 1e-12) at hidden
    128, two heads of 64, three layers, 56px."""
    cfg = dataclasses.replace(JD.DinoConfig.from_type(getattr(request, "param", "dinov2")), image_size=56,
                              hidden_size=DIM, num_layers=3, num_heads=2, mlp_ratio=2)
    tcfg = TD.DinoConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = JD.init_dino(jax.random.PRNGKey(0), cfg)
    lora = JL.init_lora(jax.random.PRNGKey(1), jp, rank=2)
    # B != 0, so that the adapters' A-grads are not all zero
    rng = np.random.default_rng(2)
    lora = [{t: {"a": e["a"], "b": jnp.asarray(0.05 * rng.standard_normal(e["b"].shape), jnp.float32)}
             for t, e in layer.items()} for layer in lora]
    return cfg, tcfg, jp, C.dino_from_jax(_np(jp)), lora


def _cfg(remat="none"):
    return CfgNode({
        "model_cfg": {"dim": DIM, "feature_size": FS, "ema_weight": 0.99, "dis_use_features": False,
                      "lora": {"enable": True, "rank": 2, "alpha": 4.0, "lr": 1e-4, "remat": remat}},
        "train_cfg": {"max_epoch": 25, "start_finetune": -5, "merge_method": "dis", "lr0": 2e-4,
                      "dis_lr0": 1e-3, "step_lr_gamma": 0.95, "step_lr_size": 25},
    })


def _assert_trees_close(got, want, rtol, atol, what):
    """Two port trees, matched by key, index or field (not by leaf order)."""
    if isinstance(got, torch.Tensor):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol, atol=atol, err_msg=what)
    elif isinstance(got, dict):
        assert set(got) == set(want), what
        for key in got:
            _assert_trees_close(got[key], want[key], rtol, atol, f"{what}.{key}")
    else:
        assert len(got) == len(want), what
        names = getattr(got, "_fields", range(len(got)))
        for name, g, w in zip(names, got, want):
            _assert_trees_close(g, w, rtol, atol, f"{what}.{name}")


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "layer", "dots"])
def test_lora_grads_through_backbone_match_jax(tiny, remat):
    cfg, tcfg, jp, tp, lora = tiny
    px = np.random.default_rng(3).standard_normal((2, 56, 56, 3)).astype(np.float32)

    def loss_j(lo):
        out = JL.lora_forward(jax.lax.stop_gradient(jp), lo, jnp.asarray(px), cfg, rank=2, alpha=4.0,
                              compute_dtype=jnp.float32, remat=remat)
        return jnp.sum(out["key_features"] ** 2)

    want = C.lora_from_jax(_np(jax.grad(loss_j)(lora)))
    lt = [{t: {n: x.requires_grad_(True) for n, x in e.items()} for t, e in layer.items()}
          for layer in C.lora_from_jax(_np(lora))]
    out = TL.lora_forward(tp, lt, torch.from_numpy(px), tcfg, rank=2, alpha=4.0, remat=remat)
    torch.sum(out["key_features"] ** 2).backward()
    assert all(p.grad is None for p in C.tree_leaves(tp))  # the backbone stays frozen
    # the last layer's q and v adapters reach no output: no grad here, zeros in JAX
    assert all(lt[-1][t]["a"].grad is None for t in "qv")
    grads = C.tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, lt)
    _assert_trees_close(grads, want, 5e-4, 1e-5, f"lora grad (remat={remat})")


def test_init_and_apply_lora(tiny):
    cfg, tcfg, jp, tp, lora = tiny
    fresh = TL.init_lora(7, tp, rank=2)
    assert len(fresh) == cfg.num_layers
    a, b = fresh[0]["q"]["a"], fresh[0]["q"]["b"]
    assert tuple(a.shape) == (2, DIM) and tuple(b.shape) == (DIM, 2) and not b.any()
    assert 0.01 < a.std().item() < 0.03
    merged0 = TL.apply_lora(tp, fresh)
    torch.testing.assert_close(merged0["layers"][1]["v"]["w"], tp["layers"][1]["v"]["w"], rtol=0, atol=0)
    # the layouts round-trip exactly
    for a, b in zip(jax.tree_util.tree_leaves(C.lora_to_jax(C.lora_from_jax(_np(lora)))),
                    jax.tree_util.tree_leaves(_np(lora))):
        np.testing.assert_array_equal(a, b)
    # the merge against the JAX package's on the same adapters
    merged = TL.apply_lora(tp, C.lora_from_jax(_np(lora)), rank=2, alpha=4.0)
    want = C.dino_from_jax(_np(JL.apply_lora(jp, lora, 2, 4.0)))
    _assert_trees_close(merged, want, 1e-6, 1e-7, "merged params")


test_init_and_apply_lora_on_dinov1 = on_dinov1(test_init_and_apply_lora, "tiny")


def test_lora_and_merged_backbone_checkpoints_round_trip(tiny, tmp_path):
    """Through real files: the port reads and writes the JAX package's
    adapter format, and the merged backbone is a HuggingFace checkpoint that
    both packages load exactly."""
    cfg, tcfg, jp, tp, lora = tiny
    lt = C.lora_from_jax(_np(lora))
    TL.save_lora_checkpoint(str(tmp_path / "port.safetensors"), lt)
    for a, b in zip(jax.tree_util.tree_leaves(JL.load_lora_checkpoint(str(tmp_path / "port.safetensors"))),
                    jax.tree_util.tree_leaves(_np(lora))):
        np.testing.assert_array_equal(np.asarray(a), b)
    JL.save_lora_checkpoint(str(tmp_path / "jax.safetensors"), lora)
    _assert_trees_close(TL.load_lora_checkpoint(str(tmp_path / "jax.safetensors")), lt, 0, 0, "adapters")

    path = str(tmp_path / "merged.safetensors")
    TL.save_merged_backbone(path, tp, lt, tcfg)
    merged = TL.apply_lora(tp, lt)
    _assert_trees_close(TD.load_hf_checkpoint(path, tcfg), merged, 0, 0, "merged backbone (port)")
    for a, b in zip(jax.tree_util.tree_leaves(JD.load_hf_checkpoint(path, cfg)),
                    jax.tree_util.tree_leaves(C.dino_to_jax(merged))):
        np.testing.assert_array_equal(np.asarray(a), b)


test_lora_and_merged_backbone_checkpoints_round_trip_on_dinov1 = on_dinov1(
    test_lora_and_merged_backbone_checkpoints_round_trip, "tiny")


def test_qkv_masters_stay_float32(tiny):
    _, _, _, tp, _ = tiny
    cast = TD.cast_params(tp, torch.bfloat16, qkv_masters=True)
    layer = cast["layers"][0]
    assert layer["q"]["w"].dtype == layer["v"]["w"].dtype == torch.float32
    assert layer["fc1"]["w"].dtype == layer["out"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# discriminator and small ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_features", [False, True])
def test_discriminator_forward_and_stats_match_jax(use_features):
    dim = 16
    jparams, jstats = JDis.init_discriminator(jax.random.PRNGKey(4), feature_size=FS, feature_dim=dim,
                                              use_features=use_features)
    tparams, tstats = C.discriminator_from_jax(_np(jparams), _np(jstats))
    rng = np.random.default_rng(5)
    mask = (rng.random((3, FS, FS, 1)) > 0.5).astype(np.float32)
    feats = rng.standard_normal((3, FS, FS, dim)).astype(np.float32)
    p_j, s_j = JDis.discriminator_forward(jparams, jstats, jnp.asarray(mask), jnp.asarray(feats))
    p_t, s_t = TDis.discriminator_forward(tparams, tstats, torch.from_numpy(mask), torch.from_numpy(feats))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5, atol=1e-6)
    _assert_trees_close(s_t, C.discriminator_from_jax(_np(jparams), _np(s_j))[1], 1e-5, 1e-6, "bn stats")
    # layouts round-trip exactly; the port's own init has the same shapes
    back_p, back_s = C.discriminator_to_jax(tparams, tstats)
    for a, b in zip(jax.tree_util.tree_leaves(back_p), jax.tree_util.tree_leaves(_np(jparams))):
        np.testing.assert_array_equal(a, b)
    own = TDis.init_discriminator(0, FS, dim, use_features)
    C.tree_map(lambda t: t.zero_(), own)
    _assert_trees_close(own, C.tree_map(torch.zeros_like, (tparams, tstats)), 0, 0, "init shapes")


def test_losses_resize_and_optimizer_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((8, 5)).astype(np.float32)
    targets = (rng.random((8, 5)) > 0.5).astype(np.float32)
    probs = rng.random((8, 1)).astype(np.float32)
    np.testing.assert_allclose(TT.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)).item(),
                               float(JT.bce_with_logits(jnp.asarray(logits), jnp.asarray(targets))), rtol=1e-6)
    np.testing.assert_allclose(TT.bce_probs(torch.from_numpy(probs), torch.zeros(8, 1)).item(),
                               float(JT.bce_probs(jnp.asarray(probs), jnp.zeros((8, 1)))), rtol=1e-6)
    x = rng.standard_normal((2, 3, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(interpolate_bilinear(torch.from_numpy(x), (9, 7)).numpy(),
                               np.asarray(j_bilinear(jnp.asarray(x), (9, 7))), rtol=1e-5, atol=1e-6)
    # the resize matrices are cached per size: one first built under
    # inference_mode (serving) must still serve a differentiated caller
    with torch.inference_mode():
        interpolate_bilinear(torch.zeros(1, 1, 5, 6), (11, 13))
    xg = torch.zeros(1, 1, 5, 6, requires_grad=True)
    interpolate_bilinear(xg, (11, 13)).sum().backward()
    assert xg.grad is not None
    # differentiable, with torch's own bilinear gradient
    xs = [torch.from_numpy(x).requires_grad_(True) for _ in range(2)]
    w = torch.from_numpy(rng.standard_normal((2, 3, 9, 7)).astype(np.float32))
    (interpolate_bilinear(xs[0], (9, 7)) * w).sum().backward()
    (torch.nn.functional.interpolate(xs[1], (9, 7), mode="bilinear", align_corners=False) * w).sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, rtol=1e-5, atol=1e-5)

    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    g = rng.standard_normal((4, 3)).astype(np.float32)
    wt = torch.from_numpy(w0.copy()).requires_grad_(True)
    opt = TT.make_optimizer([wt], 2e-4, 0.95, 3)
    tx = JT.make_optimizer(2e-4, 0.95, 3)
    wj = jnp.asarray(w0)
    state = tx.init(wj)
    for _ in range(8):
        opt.zero_grad()
        wt.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, wj)
        wj = wj + updates
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the three train steps, three steps each from the same initial trees
# ---------------------------------------------------------------------------


def _states(cfg):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(8), 3)
    dec, ema = JB.init_rev_decoder(k1, DIM), JB.init_rev_decoder(k2, DIM)
    dis_p, dis_s = JDis.init_discriminator(k3, feature_size=FS, feature_dim=DIM, use_features=False)
    tx, dis_tx = JT.make_optimizer(2e-4, 0.95, 25), JT.make_optimizer(1e-3, 0.95, 25)
    jstate = JT.TrainState(decoder=dec, decoder_ema=ema, opt_state=tx.init(dec), dis_params=dis_p,
                           dis_stats=dis_s, dis_opt_state=dis_tx.init(dis_p), ema_step=jnp.zeros((), jnp.int32))
    tstate = TT.init_train_state(C.decoder_from_jax(_np(dec)), C.decoder_from_jax(_np(ema)),
                                 *C.discriminator_from_jax(_np(dis_p), _np(dis_s)), cfg.train_cfg, "cpu")
    return jstate, tstate, tx, dis_tx


def _batch(seed, grid=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, grid, grid, DIM)).astype(np.float32),
            (rng.random((4, 16, 16, 1)) > 0.5).astype(np.float32))


def _assert_aux_close(aux_t, aux_j, keys):
    for key in keys:
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-5, atol=1e-6, err_msg=key)


def _assert_states_close(tstate, jstate, steps=3, lr=2e-4):
    """Decoder and EMA after ``steps`` AdamW steps.  The learnable embedding's
    gradient is zero in exact arithmetic (the token-axis L2 normalisation
    cancels a per-channel scale), so AdamW turns its rounding noise into
    steps of up to lr either way: it is held to 2 * lr per step."""
    for name, got, want in (("decoder", tstate.decoder, jstate.decoder),
                            ("ema", tstate.decoder_ema, jstate.decoder_ema)):
        want = C.decoder_from_jax(_np(want))
        _assert_trees_close(got._replace(learnable_embedding=want.learnable_embedding), want, 1e-4, 1e-5, name)
        _assert_trees_close(got.learnable_embedding, want.learnable_embedding, 0, 2 * lr * steps,
                            f"{name}.learnable_embedding")
    assert tstate.ema_step == int(jstate.ema_step)


def _jax_decoder_loss(jstate, f, pl, epoch, adv, f_apm=None):
    """The JAX steps' student loss as a function of the decoder (the APM
    merge reads ``f_apm``, default ``f``; max_epoch + start_finetune = 20)."""
    f_sg = jax.lax.stop_gradient(f)
    tb = (jax.nn.sigmoid(JB.rev_decoder_forward(jstate.decoder_ema, f_sg, with_loss=False)[0]) > 0.5
          ).astype(jnp.float32)
    return lambda dec: JT._stage1_decoder_loss(dec, jstate, f, pl, tb, epoch, adv, True, 20, f_apm=f_apm)[0]


def test_train_step_matches_jax_at_step_3():
    cfg = _cfg()
    jstate, tstate, tx, _ = _states(cfg)
    jstep, tstep = jax.jit(JT.make_train_step(cfg, tx)), TT.make_train_step(cfg)
    for i, (epoch, adv) in enumerate(((0.0, 1.0), (1.0, 1.0), (2.0, 0.0))):
        f, pl = _batch(10 + i)
        if i == 2:  # the JAX gradients at the state step 3 starts from
            fj = JT._to_feature_size(jnp.asarray(f), FS)
            plj = JT._to_feature_size(jnp.asarray(pl), FS)
            want = jax.grad(_jax_decoder_loss(jstate, fj, plj, epoch, adv))(jstate.decoder)
        jstate, aux_j = jstep(jstate, jnp.asarray(f), jnp.asarray(pl), jnp.float32(epoch), jnp.float32(adv))
        aux_t = tstep(tstate, torch.from_numpy(f), torch.from_numpy(pl), epoch, adv)
        _assert_aux_close(aux_t, aux_j, ("loss", "dis_loss", "ortho_loss", "merge_weight", "p_s", "p_p"))
    _assert_trees_close(C.tree_map(lambda t: t.grad, tstate.decoder), C.decoder_from_jax(_np(want)),
                        1e-4, 1e-6, "decoder grad at step 3")
    _assert_states_close(tstate, jstate)


def test_discriminator_step_matches_jax_at_step_3():
    cfg = _cfg()
    jstate, tstate, _, dis_tx = _states(cfg)
    jstep, tstep = jax.jit(JT.make_discriminator_step(cfg, dis_tx)), TT.make_discriminator_step(cfg)
    for i in range(3):
        f, pl = _batch(20 + i)
        if i == 2:  # the JAX gradients at the state step 3 starts from
            want = jax.grad(_jax_dis_loss(jstate, jnp.asarray(f), jnp.asarray(pl)))(jstate.dis_params)
        jstate, aux_j = jstep(jstate, jnp.asarray(f), jnp.asarray(pl))
        aux_t = tstep(tstate, torch.from_numpy(f), torch.from_numpy(pl))
        _assert_aux_close(aux_t, aux_j, ("dis_train_loss",))
    _assert_trees_close(C.tree_map(lambda t: t.grad, tstate.dis_params),
                        C.discriminator_from_jax(_np(want), _np(jstate.dis_stats))[0], 1e-4, 1e-6,
                        "dis grad at step 3")
    want_p, want_s = C.discriminator_from_jax(_np(jstate.dis_params), _np(jstate.dis_stats))
    _assert_trees_close(tstate.dis_params, want_p, 1e-4, 1e-5, "dis params")
    _assert_trees_close(tstate.dis_stats, want_s, 1e-5, 1e-6, "dis stats")


def _jax_dis_loss(jstate, f, pl):
    """The JAX make_discriminator_step's loss, as a function of its params."""
    f = JT._to_feature_size(f, FS)
    fg = JB.rev_decoder_forward(jstate.decoder, f, with_loss=False)[0]
    student_bin = (jax.nn.sigmoid(fg) > 0.5).astype(jnp.float32)
    pl_bin = (JT._to_feature_size(pl, FS) > 0.5).astype(jnp.float32)

    def loss(params):
        p_s, stats1 = JDis.discriminator_forward(params, jstate.dis_stats, student_bin, f)
        p_p, _ = JDis.discriminator_forward(params, stats1, pl_bin, f)
        return JT.bce_probs(jnp.concatenate([p_s, p_p]),
                            jnp.concatenate([jnp.zeros_like(p_s), jnp.ones_like(p_p)]))

    return loss


def test_lora_train_step_matches_jax_at_step_3(tiny):
    cfg_d, tcfg, jp, tp, lora = tiny
    cfg = _cfg()
    jstate, tstate, tx, _ = _states(cfg)
    ltx = JT.make_optimizer(1e-4, 0.95, 25)
    jlora = JL.init_lora(jax.random.PRNGKey(11), jp, rank=2)
    jlopt = ltx.init(jlora)
    tlora = C.tree_map(lambda t: t.requires_grad_(True), C.lora_from_jax(_np(jlora)))
    tlopt = TT.make_optimizer(C.tree_leaves(tlora), 1e-4, 0.95, 25)
    jstep = jax.jit(JT.make_lora_train_step(cfg, tx, ltx, cfg_d, jnp.float32))
    tstep = TT.make_lora_train_step(cfg, tcfg, torch.float32)
    rng = np.random.default_rng(12)
    for i, (epoch, adv) in enumerate(((0.0, 1.0), (1.0, 1.0), (2.0, 1.0))):
        px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
        pl = (rng.random((2, 16, 16, 1)) > 0.5).astype(np.float32)
        if i == 2:
            want = jax.grad(_jax_lora_loss(cfg_d, jstate, jp, jnp.asarray(px), jnp.asarray(pl), epoch, adv))(
                (jstate.decoder, jlora))
        jstate, jlora, jlopt, aux_j = jstep(jstate, jlora, jlopt, jp, jnp.asarray(px), jnp.asarray(pl),
                                            jnp.float32(epoch), jnp.float32(adv))
        aux_t = tstep(tstate, tlora, tlopt, tp, torch.from_numpy(px), torch.from_numpy(pl), epoch, adv)
        _assert_aux_close(aux_t, aux_j, ("loss", "dis_loss", "ortho_loss", "merge_weight", "p_s", "p_p"))
        np.testing.assert_allclose(float(aux_t["lora_grad_norm"]), float(aux_j["lora_grad_norm"]), rtol=5e-4)
        if i == 0:  # B = 0 at init: the first step's A-grads are exactly zero
            assert all(not e["a"].grad.any() for layer in tlora for e in layer.values())
    _assert_trees_close(C.tree_map(lambda t: t.grad, tstate.decoder), C.decoder_from_jax(_np(want[0])),
                        5e-4, 1e-5, "decoder grad at step 3")
    _assert_trees_close(C.tree_map(lambda t: t.grad, tlora), C.lora_from_jax(_np(want[1])),
                        5e-4, 1e-5, "lora grad at step 3")
    assert any(e["a"].grad.abs().sum() > 0 for layer in tlora for e in layer.values())
    _assert_states_close(tstate, jstate)
    _assert_trees_close(tlora, C.lora_from_jax(_np(jlora)), 1e-4, 1e-5, "adapters")


test_lora_train_step_matches_jax_at_step_3_on_dinov1 = on_dinov1(test_lora_train_step_matches_jax_at_step_3, "tiny")


def _jax_lora_loss(dcfg, jstate, jp, px, pl, epoch, adv):
    """The JAX make_lora_train_step's loss, as a function of (decoder, lora)."""
    plj = JT._to_feature_size(pl, FS)

    def loss(params):
        dec, lo = params
        out = JL.lora_forward(jax.lax.stop_gradient(jp), lo, px, dcfg, rank=2, alpha=4.0,
                              compute_dtype=jnp.float32, remat="none")
        f = JT._to_feature_size(out["key_features"].astype(jnp.float32), FS)
        return _jax_decoder_loss(jstate, f, plj, epoch, adv, f_apm=jax.lax.stop_gradient(f))(dec)

    return loss


def test_step_guards():
    bad = _cfg()
    bad.train_cfg.start_finetune = -25  # max_epoch + start_finetune == 0
    for make in (TT.make_train_step, lambda c: TT.make_lora_train_step(c, None, torch.float32)):
        with pytest.raises(ValueError):
            make(bad)
    tcfg = TD.DinoConfig(image_size=28, hidden_size=128, num_layers=2, num_heads=2)
    tp = TD.init_dino(0, tcfg)
    with pytest.raises(ValueError, match="dots"):  # the three JAX modes, nothing else
        TL.lora_forward(tp, TL.init_lora(0, tp), torch.zeros(1, 28, 28, 3), tcfg, remat="typo")


def test_remat_dots_saves_the_products_and_matches_none(tiny):
    """remat "dots" (the JAX ``dots_with_no_batch_dims_saveable`` policy):
    the same forward and adapter gradients as "none" bit for bit on the CPU
    (the recomputed chains are deterministic), the products' outputs saved
    (the policy sees one ``aten.mm`` per projection) and the rest marked for
    recomputation."""
    cfg, tcfg, jp, tp, lora = tiny
    px = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 56, 56, 3)).astype(np.float32))
    seen = []
    orig = TD._dots_policy

    def recording(ctx, op, *a, **k):
        seen.append((ctx.is_recompute, op))
        return orig(ctx, op, *a, **k)

    grads = {}
    for remat in ("none", "dots"):
        lt = [{t: {n: x.clone().requires_grad_(True) for n, x in e.items()} for t, e in layer.items()}
              for layer in C.lora_from_jax(_np(lora))]
        TD._dots_policy = recording
        try:
            out = TL.lora_forward(tp, lt, px, tcfg, rank=2, alpha=4.0, remat=remat)["key_features"]
            torch.sum(out ** 2).backward()
        finally:
            TD._dots_policy = orig
        grads[remat] = (out.detach(), [p.grad for layer in lt[:-1] for e in layer.values() for p in e.values()])
    assert torch.equal(grads["dots"][0], grads["none"][0])
    for a, b in zip(grads["dots"][1], grads["none"][1]):
        assert torch.equal(a, b)
    saved = [op for rec, op in seen if not rec and op in TD._DOTS_SAVED]
    assert len(saved) == 6 * (tcfg.num_layers - 1)  # q, k, v, out, fc1, fc2 per checkpointed layer
    # the rest is marked for recomputation: the LayerNorms and the GELU among it
    assert {torch.ops.aten.native_layer_norm.default, torch.ops.aten.gelu.default} <= {
        op for _, op in seen if op not in TD._DOTS_SAVED}
