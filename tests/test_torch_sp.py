"""The port's sequence parallelism against the JAX package's.

``ring_attention``, ``dino_forward(sp_shard=)`` (1D and 2D SP x TP, the key
fold), ``make_lora_train_step(sp_shard=)`` and ``FeatureExtractor`` with a
``seq`` mesh axis of ``ucod_dpl_tpu_torch`` take the same numpy inputs and
weights as their JAX counterparts, which run on the 8-device CPU mesh as
tests/test_sp.py and tests/test_sp_tp_2d.py run them.  The port's meshes
name the CPU eight times, so its chunks run one after another; on the CPU
the ring's kernels are their plain versions.  The model is tests/test_sp.py's
CFG (hidden 128, 2 layers, 8 heads of 16, 28px: 5 tokens, padded to 8 on
the ring).  Tolerances are JAX's own: 1e-5 / 1e-6 for the ring, 1e-4 / 1e-5
for its gradients, 2e-5 / 2e-6 for the backbone, 2e-4 / 2e-5 for the
extractor, tests/test_sp.py:298-319's for the LoRA step.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.engine import train_step as JT
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu.models.dba import init_rev_decoder as j_init_decoder
from ucod_dpl_tpu.models.discriminator import init_discriminator as j_init_discriminator
from ucod_dpl_tpu.parallel import build_mesh as jax_build_mesh
from ucod_dpl_tpu.parallel.sp import ring_attention as jax_ring_attention
from ucod_dpl_tpu.parallel.tp import shard_dino_params as jax_shard_dino_params
from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.engine import train_step as TT
from ucod_dpl_tpu_torch.engine.runner import Runner
from ucod_dpl_tpu_torch.engine.train_loop import TrainLoop
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder
from ucod_dpl_tpu_torch.models.safetensors_io import save_decoder_checkpoint
from ucod_dpl_tpu_torch.ops.attention import multi_head_attention, packed_attention_fwd_lse
from ucod_dpl_tpu_torch.parallel import build_mesh, data_sharding
from ucod_dpl_tpu_torch.parallel import sp as SP
from ucod_dpl_tpu_torch.parallel.tp import shard_dino_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_eval import ARCH as EVAL_ARCH, _cfg_dict as eval_cfg_dict, _make_dataset  # noqa: E402
from test_torch_train_loop import PortRunner, _lora_cfg_dict, _lora_world, run_loop  # noqa: E402

ARCH = dict(image_size=28, patch_size=14, hidden_size=128, num_layers=2, num_heads=8, mlp_ratio=2)
CFG = JD.DinoConfig(variant="dinov2", use_layerscale=True, **ARCH)  # tests/test_sp.py's CFG
TCFG = TD.DinoConfig(variant="dinov2", use_layerscale=True, **ARCH)
RING_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
MESHES_2D = [{"data": 2, "model": 2, "seq": 2}, {"model": 2, "seq": 4}, {"model": 4, "seq": 2}]


def _ids(m):
    return "x".join(f"{k}{v}" for k, v in m.items())


def _cpu_mesh(mesh_cfg):
    return build_mesh(mesh_cfg, devices=["cpu"] * 8)


def _qkv(b, l, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, d)).astype(np.float32) for _ in range(3))


def _kv_lens(l_pad, l_valid, n):
    c = l_pad // n
    return [max(0, min(c, l_valid - i * c)) for i in range(n)]


def _port_ring(q, k, v, nh, mesh, l_valid, scale, h_axis=None, requires_grad=False):
    """The port's ring per data coordinate over (B, L_pad, D) numpy inputs:
    the batch split as the JAX ring splits it, the tokens into the ``seq``
    chunks (and the columns into the ``h_axis`` shards).  Returns the output
    and the leaf tensors per data coordinate."""
    n = mesh.shape["seq"]
    tp = mesh.shape.get(h_axis, 1) if h_axis else 1
    outs, leaves = [], []
    slices = data_sharding(mesh, q.shape[0])
    for sl in slices[:1] if slices[0] == slice(None) else slices:  # a replicated batch runs once
        ts = [torch.from_numpy(x[sl].copy()).requires_grad_(requires_grad) for x in (q, k, v)]
        leaves.append(ts)
        chunks = [[list(c.chunk(n, dim=1)) for c in t.chunk(tp, dim=-1)] for t in ts]
        if h_axis is None:
            chunks = [c[0] for c in chunks]
        got = SP.ring_attention(*chunks, nh, scale=scale, kv_lens=_kv_lens(q.shape[1], l_valid, n), mesh=mesh,
                                h_axis=h_axis)
        if h_axis is None:
            got = [got]
        outs.append(torch.cat([torch.cat(row, dim=1) for row in got], dim=-1))
    return torch.cat(outs), leaves


def _jax_ring(q, k, v, nh, mesh_cfg, l_valid, scale, h_axis=None):
    jmesh = jax_build_mesh(mesh_cfg)
    valid = jnp.broadcast_to(jnp.arange(q.shape[1]) < l_valid, (q.shape[0], q.shape[1]))
    return np.asarray(jax.jit(lambda q, k, v: jax_ring_attention(
        q, k, v, nh, scale=scale, mesh=jmesh, axis="seq", valid=valid, h_axis=h_axis))(q, k, v))


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_cfg", [{"data": 2, "seq": 4}, {"seq": 8}], ids=_ids)
def test_ring_attention_matches_jax(mesh_cfg):
    q, k, v = _qkv(2, 64, 128, 0)
    got, _ = _port_ring(q, k, v, 8, _cpu_mesh(mesh_cfg), 64, 0.125)
    np.testing.assert_allclose(got.numpy(), _jax_ring(q, k, v, 8, mesh_cfg, 64, 0.125), **RING_TOL)


@pytest.mark.parametrize("l_valid,l_pad", [(37, 40), (5, 8)])
def test_ring_attention_padding_matches_jax_and_skips_empty_chunks(l_valid, l_pad, monkeypatch):
    """Padded keys add nothing: the valid rows equal JAX's ring and dense
    attention on the valid tokens alone.  At 5 tokens over 8 chunks, chunks 5-7
    hold no real key and are never launched (the forward with log-sum-exp is
    called once per query chunk and real key chunk, never with kv_len 0)."""
    q, k, v = _qkv(2, l_pad, 128, 1)
    calls = []
    orig = SP.packed_attention_fwd_lse

    def recording(*a, kv_len=None, **kw):
        calls.append(kv_len)
        return orig(*a, kv_len=kv_len, **kw)

    monkeypatch.setattr(SP, "packed_attention_fwd_lse", recording)
    got, _ = _port_ring(q, k, v, 8, _cpu_mesh({"seq": 8}), l_valid, 0.125)
    lens = _kv_lens(l_pad, l_valid, 8)
    assert sorted(calls) == sorted([n for n in lens if n] * 8)
    want = _jax_ring(q, k, v, 8, {"seq": 8}, l_valid, 0.125)
    np.testing.assert_allclose(got.numpy()[:, :l_valid], want[:, :l_valid], **RING_TOL)
    dense = multi_head_attention(*(torch.from_numpy(x[:, :l_valid].copy()) for x in (q, k, v)), 8, 0.125)
    np.testing.assert_allclose(got.numpy()[:, :l_valid], dense.numpy(), **RING_TOL)
    assert np.isfinite(got.numpy()).all()


def test_ring_attention_n1_is_one_masked_call(monkeypatch):
    """The no-ring path (seq axis of 1): one call with the key bound."""
    b, l_valid, l_pad, d, nh = 2, 13, 16, 64, 4
    q, k, v = _qkv(b, l_pad, d, 2)
    calls = []
    orig = SP.packed_attention_fwd_lse
    monkeypatch.setattr(SP, "packed_attention_fwd_lse", lambda *a, **kw: calls.append(kw) or orig(*a, **kw))
    got, _ = _port_ring(q, k, v, nh, _cpu_mesh({"data": 8, "seq": 1}), l_valid, 0.25)
    assert len(calls) == 1 and calls[0]["kv_len"] == l_valid and "out_dtype" not in calls[0]
    want = _jax_ring(q, k, v, nh, {"data": 8, "seq": 1}, l_valid, 0.25)
    np.testing.assert_allclose(got.numpy()[:, :l_valid], want[:, :l_valid], **RING_TOL)


def _jax_ring_grads(q, k, v, w, nh, mesh_cfg, l_valid, scale, h_axis=None):
    jmesh = jax_build_mesh(mesh_cfg)
    valid = jnp.broadcast_to(jnp.arange(q.shape[1]) < l_valid, (q.shape[0], q.shape[1]))

    def loss(q, k, v):
        o = jax_ring_attention(q, k, v, nh, scale=scale, mesh=jmesh, axis="seq", valid=valid, h_axis=h_axis)
        return jnp.sum(o[:, :l_valid] * w)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def _port_ring_grads(q, k, v, w, nh, mesh, l_valid, scale, h_axis=None):
    out, leaves = _port_ring(q, k, v, nh, mesh, l_valid, scale, h_axis=h_axis, requires_grad=True)
    torch.sum(out[:, :l_valid] * torch.from_numpy(w)).backward()
    return [torch.cat([ts[i].grad for ts in leaves]).numpy() for i in range(3)]


def _assert_ring_grads(got, want, l_valid, what):
    for name, a, r in zip("qkv", got, want):
        np.testing.assert_allclose(a, r, err_msg=f"d{name} {what}", **GRAD_TOL)
        if name in "kv":  # padded keys: exact zeros
            assert np.all(a[:, l_valid:] == 0.0), f"d{name} {what}"


@pytest.mark.parametrize("mesh_cfg", [{"data": 2, "seq": 4}, {"seq": 8}], ids=_ids)
def test_ring_attention_grads_match_jax(mesh_cfg):
    """RingAttention's backward (a flash backward per chunk pair from the
    global output and log-sum-exp) against jax.grad of JAX's ring, with
    padding (19 of 24 tokens: over 8 chunks the last holds none)."""
    b, l_valid, l_pad, d, nh, scale = 2, 19, 24, 128, 8, 0.125
    q, k, v = _qkv(b, l_pad, d, 3)
    w = np.random.default_rng(4).standard_normal((b, l_valid, d)).astype(np.float32)
    got = _port_ring_grads(q, k, v, w, nh, _cpu_mesh(mesh_cfg), l_valid, scale)
    _assert_ring_grads(got, _jax_ring_grads(q, k, v, w, nh, mesh_cfg, l_valid, scale), l_valid, str(mesh_cfg))


def test_ring_attention_is_deterministic_and_keeps_dtype():
    """Chunk pairs run in a fixed order: two runs give equal outputs and
    gradients bit for bit; bf16 chunks come back bf16."""
    q, k, v = (x.astype(np.float32) for x in _qkv(1, 24, 128, 5))
    mesh = _cpu_mesh({"seq": 8})
    runs = [_port_ring_grads(q, k, v, np.ones((1, 21, 128), np.float32), 8, mesh, 21, 0.125) for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    chunks = [list(torch.from_numpy(x).to(torch.bfloat16).chunk(8, dim=1)) for x in (q, k, v)]
    out = SP.ring_attention(*chunks, 8, scale=0.125, kv_lens=_kv_lens(24, 21, 8), mesh=mesh)
    assert all(o.dtype == torch.bfloat16 and o.shape == (1, 3, 128) for o in out)


@pytest.mark.parametrize("mesh_cfg", MESHES_2D, ids=_ids)
def test_ring_attention_2d_matches_jax(mesh_cfg):
    """Heads over ``model``, tokens ringing over ``seq``: forward (37 of 40
    tokens) and gradients (19 of 24) against JAX's 2D ring."""
    mesh = _cpu_mesh(mesh_cfg)
    q, k, v = _qkv(2, 40, 128, 6)
    got, _ = _port_ring(q, k, v, 8, mesh, 37, 0.125, h_axis="model")
    want = _jax_ring(q, k, v, 8, mesh_cfg, 37, 0.125, h_axis="model")
    np.testing.assert_allclose(got.numpy()[:, :37], want[:, :37], **RING_TOL)
    q, k, v = _qkv(2, 24, 128, 7)
    w = np.random.default_rng(8).standard_normal((2, 19, 128)).astype(np.float32)
    got = _port_ring_grads(q, k, v, w, 8, mesh, 19, 0.125, h_axis="model")
    _assert_ring_grads(got, _jax_ring_grads(q, k, v, w, 8, mesh_cfg, 19, 0.125, h_axis="model"), 19,
                       str(mesh_cfg))


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


def _params(seed):
    jp = JD.init_dino(jax.random.PRNGKey(seed), CFG)
    return jp, C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _pixels(seed, b, hw=28):
    return np.random.default_rng(seed).standard_normal((b, hw, hw, 3)).astype(np.float32)


def _jax_sharded(jp, px, mesh_cfg, tp=False, sp=True, **kw):
    jmesh = jax_build_mesh(mesh_cfg)
    shard = {}
    if sp:
        shard["sp_shard"] = (jmesh, "seq")
    if tp:
        shard["tp_shard"] = (jmesh, "model")
        jp = jax_shard_dino_params(jp, jmesh)
    pxs = jax.device_put(jnp.asarray(px), NamedSharding(jmesh, P("data", None, None, None))) \
        if "data" in mesh_cfg else jnp.asarray(px)
    return jax.jit(lambda p, x: JD.dino_forward(p, x, CFG, **shard, **kw))(jp, pxs)


def _port_sharded(params, px, mesh, tp=False, sp=True, **kw):
    """The port's sharded forward per data coordinate, on that coordinate's
    placed params (sp_param_grid / shard_dino_params)."""
    outs = []
    slices = data_sharding(mesh, px.shape[0])
    for d, sl in enumerate(slices[:1] if slices[0] == slice(None) else slices):
        shard = {}
        if sp:
            shard["sp_shard"] = (mesh, "seq")
            p = SP.sp_param_grid(params, mesh, "seq", "model" if tp else None, data=d)
        else:
            p = shard_dino_params(params, mesh)[d]
        if tp:
            shard["tp_shard"] = (mesh, "model")
        outs.append(TD.dino_forward(p, torch.from_numpy(px[sl]), TCFG, **shard, **kw))
    return {k: torch.cat([o[k] for o in outs]).numpy() for k in outs[0]}


@pytest.mark.parametrize("mesh_cfg,tp", [({"data": 2, "seq": 4}, False), ({"seq": 8}, False),
                                         ({"data": 2, "model": 2, "seq": 2}, True)],
                         ids=["data2xseq4", "seq8", "2d-data2xmodel2xseq2"])
def test_sp_dino_forward_matches_jax(mesh_cfg, tp):
    """5 tokens padded to 8 on the ring; 1D SP and 2D SP x TP against the
    JAX package's sharded forward and the port's unsharded one."""
    jp, params = _params(0)
    px = _pixels(0, 4)
    want = np.asarray(_jax_sharded(jp, px, mesh_cfg, tp=tp)["key_features"])
    got = _port_sharded(params, px, _cpu_mesh(mesh_cfg), tp=tp)
    assert set(got) == {"key_tokens", "key_features"} and got["key_tokens"].shape == (4, 5, 128)
    np.testing.assert_allclose(got["key_features"], want, **FWD_TOL)
    unsharded = TD.dino_forward(params, torch.from_numpy(px), TCFG)
    for key, value in got.items():
        np.testing.assert_allclose(value, unsharded[key].numpy(), err_msg=key, **FWD_TOL)


def test_sp_dino_forward_places_a_params_dict_and_differentiates():
    """A params dict is placed on the mesh's data coordinate 0 (what LoRA
    training passes); gradients through the ring equal the unsharded
    differentiable forward's."""
    _, params = _params(1)
    px = torch.from_numpy(_pixels(1, 2))
    mesh = _cpu_mesh({"data": 2, "seq": 4})
    leaves = [{k: v.clone().requires_grad_(True) for k, v in params["layers"][0]["q"].items()} for _ in range(2)]
    grads = []
    for sp, q in zip(((mesh, "seq"), None), leaves):
        p = {**params, "layers": [{**params["layers"][0], "q": q}, *params["layers"][1:]]}
        out = TD.dino_forward(p, px, TCFG, differentiable=True, sp_shard=sp)["key_features"]
        (out ** 2).sum().backward()
        grads.append((out.detach(), q["w"].grad, q["b"].grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("mesh_cfg,tp,sp", [({"seq": 8}, False, True), ({"model": 2, "seq": 4}, True, True),
                                            ({"data": 2, "model": 4}, True, False)], ids=["sp", "2d", "tp"])
def test_key_fold_matches_jax(mesh_cfg, tp, sp):
    """The serving fast path (key_fold) under SP, 2D and TP alone: the fold
    per chunk, the padding sliced off before the patch-grid reshape."""
    jp, params = _params(0)
    px = _pixels(0, 2)
    rng = np.random.default_rng(1)
    fw, fb = rng.standard_normal((128, 3)).astype(np.float32), rng.standard_normal(3).astype(np.float32)
    want = np.asarray(_jax_sharded(jp, px, mesh_cfg, tp=tp, sp=sp, key_fold=(jnp.asarray(fw), jnp.asarray(fb)))[
        "folded_features"])
    got = _port_sharded(params, px, _cpu_mesh(mesh_cfg), tp=tp, sp=sp,
                        key_fold=(torch.from_numpy(fw.T.copy()), torch.from_numpy(fb)))["folded_features"]
    assert got.shape == want.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_sp_guards():
    """tests/test_sp.py::test_sp_guards, with JAX's messages."""
    _, params = _params(0)
    px = torch.zeros(1, 28, 28, 3)
    mesh = _cpu_mesh({"data": 2, "seq": 4})
    other = _cpu_mesh({"model": 2, "seq": 4})
    sp = (mesh, "seq")
    with pytest.raises(ValueError, match="share one Mesh"):
        TD.dino_forward(params, px, TCFG, sp_shard=sp, tp_shard=(other, "model"))
    with pytest.raises(ValueError, match="parity"):
        TD.dino_forward(params, px, TCFG, sp_shard=sp, want_cls_attention=True)
    with pytest.raises(ValueError, match="single-chip"):
        TD.dino_forward(params, px, TCFG, sp_shard=sp, quant={"layers": []})
    q = [torch.zeros(1, 2, 128)] * 4
    with pytest.raises(ValueError, match="differ from the ring axis"):
        SP.ring_attention(q, q, q, 8, scale=0.125, kv_lens=[2] * 4, mesh=other, axis="seq", h_axis="seq")
    with pytest.raises(ValueError, match="not divisible"):
        SP.ring_attention([q] * 2, [q] * 2, [q] * 2, 7, scale=0.125, kv_lens=[2] * 4, mesh=other, h_axis="model")
    # the wrappers refuse a chunk with no key: the ring skips it instead
    with pytest.raises(ValueError, match="kv_len"):
        packed_attention_fwd_lse(q[0], q[0], q[0], 8, 0.125, kv_len=0)
    with pytest.raises(ValueError, match="first chunk"):
        SP.ring_attention(q, q, q, 8, scale=0.125, kv_lens=[0, 2, 2, 2], mesh=other)


def test_sp_chunking_pads_at_the_end():
    """JAX's padding: -(-L // n) * n, at the end, so only the last chunks hold
    padding (2917 tokens over 4: 2920, chunks of 730, the last 727 real)."""
    assert SP.padded_len(2917, 4) == 2920 and SP.chunk_kv_lens(2917, 4) == [730, 730, 730, 727]
    assert SP.chunk_kv_lens(1370, 4) == [343, 343, 343, 341]
    assert SP.chunk_kv_lens(5, 8) == [1, 1, 1, 1, 1, 0, 0, 0]
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    chunks = SP.split_tokens(x, [torch.device("cpu")] * 4)
    assert [c.shape[1] for c in chunks] == [2, 2, 2, 2] and not chunks[-1][:, 1:].any()
    torch.testing.assert_close(SP.gather_tokens(chunks, 5, torch.device("cpu")), x, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the LoRA step
# ---------------------------------------------------------------------------


def test_sp_lora_train_step_matches_jax():
    """One LoRA joint step (remat "layer", the ring's backward,
    pad/mask/slice) under {"data": 2, "seq": 4} against JAX's
    ``make_lora_train_step(sp_shard=)`` on its 8-device mesh, with
    tests/test_sp.py:298-319's tolerances (loss rtol 1e-5, LoRA gradient norm
    1e-4, adapters and decoder within one first-Adam step)."""
    d = {"model_cfg": {"dim": 128, "feature_size": 8, "ema_weight": 0.99, "dis_use_features": False,
                       "lora": {"enable": True, "rank": 2, "alpha": 4.0, "remat": "layer"}},
         "train_cfg": {"merge_method": "dis", "max_epoch": 25, "start_finetune": -5, "lr0": 2e-4, "dis_lr0": 1e-3,
                       "step_lr_gamma": 0.95, "step_lr_size": 25}}
    backbone = JD.init_dino(jax.random.PRNGKey(2), CFG)
    lora0 = JL.init_lora(jax.random.PRNGKey(3), backbone, rank=2)
    opt, dis_opt, lora_opt = (JT.make_optimizer(lr, 0.95, 25) for lr in (2e-4, 1e-3, 1e-4))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dec, ema = j_init_decoder(k1, 128), j_init_decoder(k2, 128)
    dis_p, dis_s = j_init_discriminator(jax.random.PRNGKey(1), feature_size=8, feature_dim=128, use_features=False)
    state0 = JT.TrainState(decoder=dec, decoder_ema=ema, opt_state=opt.init(dec), dis_params=dis_p,
                           dis_stats=dis_s, dis_opt_state=dis_opt.init(dis_p), ema_step=jnp.int32(0))
    rng = np.random.default_rng(42)
    px = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    pl = (rng.random((4, 8, 8, 1)) > 0.5).astype(np.float32)
    jmesh = jax_build_mesh({"data": 2, "seq": 4})
    jstep = jax.jit(JT.make_lora_train_step(JCfg(d), opt, lora_opt, CFG, jnp.float32, sp_shard=(jmesh, "seq")))
    pxj = jax.device_put(jnp.asarray(px), NamedSharding(jmesh, P("data", None, None, None)))
    js, jlora, _, jaux = jstep(state0, lora0, lora_opt.init(lora0), backbone, pxj, jnp.asarray(pl),
                               jnp.float32(0.0), jnp.float32(1.0))

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    cfg = CfgNode(d)
    tstate = TT.init_train_state(C.decoder_from_jax(np_tree(dec)), C.decoder_from_jax(np_tree(ema)),
                                 *C.discriminator_from_jax(np_tree(dis_p), np_tree(dis_s)), cfg.train_cfg, "cpu")
    tlora = C.tree_map(lambda t: t.requires_grad_(True), C.lora_from_jax(np_tree(lora0)))
    tlopt = TT.make_optimizer(C.tree_leaves(tlora), 1e-4, 0.95, 25)
    mesh = _cpu_mesh({"data": 2, "seq": 4})
    tstep = TT.make_lora_train_step(cfg, TCFG, torch.float32, sp_shard=(mesh, "seq"))
    taux = tstep(tstate, tlora, tlopt, C.dino_from_jax(np_tree(backbone)), torch.from_numpy(px),
                 torch.from_numpy(pl), 0.0, 1.0)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["lora_grad_norm"]), float(jaux["lora_grad_norm"]), rtol=1e-4)
    want = C.lora_from_jax(np_tree(jlora))
    for got_t, want_t in zip(C.tree_leaves(tlora), C._leaves_like(tlora, want), strict=True):
        np.testing.assert_allclose(got_t.detach().numpy(), want_t.numpy(), rtol=1e-3, atol=2.5e-4)
    want_dec = C.decoder_from_jax(np_tree(js.decoder))
    for got_t, want_t in zip(C.tree_leaves(tstate.decoder), C._leaves_like(tstate.decoder, want_dec), strict=True):
        np.testing.assert_allclose(got_t.detach().numpy(), want_t.numpy(), rtol=1e-3, atol=4.5e-4)


# ---------------------------------------------------------------------------
# the extractor, the eval Runner and the LoRA TrainLoop
# ---------------------------------------------------------------------------


def _fe_cfg(weights, **arch):
    return CfgNode({"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": weights,
                    "arch": {**ARCH, **arch}})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    _, params = _params(3)
    path = tmp_path_factory.mktemp("sp") / "dino.safetensors"
    TD.save_hf_checkpoint(str(path), params, TCFG)
    return str(path)


@pytest.mark.parametrize("mesh_cfg", [{"data": 2, "seq": 4}, {"data": 2, "model": 2, "seq": 2}], ids=_ids)
def test_feature_extractor_seq_mesh_matches_unsharded(checkpoint, mesh_cfg):
    """``extract`` over a seq mesh (56px: 17 tokens over the ring) at a batch
    the data axis splits and at one it does not; ``extract_with_attention``
    runs without the seq split and equals the unsharded extractor's."""
    fe = FeatureExtractor(_fe_cfg(checkpoint), strict=True, mesh=_cpu_mesh(mesh_cfg))
    assert fe.sp_shard is not None and (fe.tp_shard is not None) == ("model" in mesh_cfg)
    plain = FeatureExtractor(_fe_cfg(checkpoint), strict=True, device="cpu")
    for b in (4, 3):
        px = _pixels(b, b, hw=56)
        got = fe.extract(px)
        assert got.shape == (b, 4, 4, 128) and got.dtype == np.float32
        np.testing.assert_allclose(got, plain.extract(px), rtol=2e-4, atol=2e-5)
    px = _pixels(9, 2, hw=56)
    for g, w in zip(fe.extract_with_attention(px), plain.extract_with_attention(px)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_feature_extractor_seq_mesh_refusals(checkpoint, monkeypatch):
    """int8 with a seq axis (JAX's "single-chip" ValueError) and a seq axis
    across processes (NotImplementedError, as for tensor parallelism)."""
    with pytest.raises(ValueError, match="single-chip"):
        FeatureExtractor(_fe_cfg(checkpoint), quantize="int8", mesh=_cpu_mesh({"data": 2, "seq": 4}))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        FeatureExtractor(_fe_cfg(checkpoint), mesh=_cpu_mesh({"data": 2, "seq": 4}))


def test_eval_runner_with_a_seq_mesh_extractor(tmp_path):
    """``Runner(mode="eval")`` given a prebuilt seq-mesh extractor: the
    LookTwice eval (cache build and crop calls through the ring) is finite
    and equal to the no-mesh run's."""
    _make_dataset(tmp_path / "RefCOD")
    dcfg = dataclasses.replace(TD.DinoConfig.from_type("dinov2"), **EVAL_ARCH)
    weights = tmp_path / "hf"
    weights.mkdir()
    TD.save_hf_checkpoint(str(weights / "model.safetensors"), TD.init_dino(0, dcfg), dcfg)
    ckpt = str(tmp_path / "decoder.safetensors")
    save_decoder_checkpoint(ckpt, init_rev_decoder(1, EVAL_ARCH["hidden_size"]),
                            init_rev_decoder(2, EVAL_ARCH["hidden_size"]))
    results = {}
    for tag, mesh in (("sp", _cpu_mesh({"data": 2, "seq": 4})), ("plain", None)):
        cfg = CfgNode(eval_cfg_dict(tmp_path, tag, weights))
        fe = mesh and FeatureExtractor(cfg.dataset_cfg.feature_extractor_cfg, compute_dtype=torch.float32,
                                       mesh=mesh)
        runner = Runner(cfg, mode="eval", load_from=ckpt, device="cpu", feature_extractor=fe)
        assert (runner.feature_extractor.sp_shard is not None) == (tag == "sp")
        results[tag] = runner.launch_val_look_twice()
    assert all(np.isfinite(v) for v in results["sp"].values())
    for key, value in results["plain"].items():
        assert abs(results["sp"][key] - value) <= 1e-4, (key, results["sp"][key], value)


def test_lora_train_loop_with_a_seq_mesh_extractor(tmp_path):
    """A 2-epoch LoRA ``TrainLoop`` (2 steps an epoch, a discriminator pass on
    the adapted forward) given a seq-mesh extractor: the steps and the
    discriminator features run through the ring, and losses and adapters
    equal the no-mesh run's within the step test's tolerances (rtol 5e-4 /
    atol 2e-5 and 1e-4 / 1e-5)."""
    _, tfe, batches, weights = _lora_world(tmp_path)
    fe_cfg = tfe.fe_cfg
    tfe_sp = FeatureExtractor(fe_cfg, compute_dtype=torch.float32, strict=True, qkv_masters=True,
                              mesh=_cpu_mesh({"data": 2, "seq": 4}))
    cfg = CfgNode(_lora_cfg_dict(tmp_path))
    loops, losses = {}, {}
    for tag, fe in (("sp", tfe_sp), ("plain", tfe)):
        loop = TrainLoop(cfg, PortRunner(weights, batches, tmp_path / tag, fe=fe))
        losses[tag] = []
        orig = loop._lora_step

        def recording(*a, _orig=orig, _key=tag):
            out = _orig(*a)
            losses[_key].append(float(out["loss"]))
            return out

        loop._lora_step = recording
        run_loop(loop)
        loops[tag] = loop
    assert len(losses["sp"]) == 4 and np.isfinite(losses["sp"]).all()
    np.testing.assert_allclose(losses["sp"], losses["plain"], rtol=5e-4, atol=2e-5)
    for a, b in zip(C.tree_leaves(loops["sp"].lora_params), C.tree_leaves(loops["plain"].lora_params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-5)
