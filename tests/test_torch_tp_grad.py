"""LoRA gradients under tensor parallelism against the JAX package.

``lora_forward(tp_shard=)`` differentiates the tensor-parallel forward: the
merged q/k/v weights placed on the model shards, LayerNorm and dense
projections per shard, each shard's attention routed as the JAX
``differentiable_mode`` routes it (``packed_attention_diff`` for an even
head count of 64 or 128 a shard, the plain version under autograd
otherwise: one head a shard at ``model=4``), the row-parallel partial sums
reduced in f32.  The same numpy weights, adapters (B nonzero) and pixels go
through it and through ``jax.grad`` of the JAX ``lora_forward(tp_shard=)``
on the 8-device CPU mesh, with the batch split over ``data`` as the JAX
mesh splits it (the port runs each data coordinate's rows and adds their
losses).  Meshes ``{"data": 4, "model": 2}`` and ``{"data": 2, "model":
4}``, head dims 64 and 128 (4 heads, 2 layers, 28px); float32; the
adapters' and the pixels' gradients at rtol 2e-4, atol 2e-5 (the JAX
attention VJP tests'), and against the port's unsharded differentiated
forward at the same bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu.parallel import build_mesh as jax_build_mesh
from ucod_dpl_tpu.parallel.tp import shard_dino_params as jax_shard_dino_params
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.models.lora import lora_forward
from ucod_dpl_tpu_torch.ops import attention as TA
from ucod_dpl_tpu_torch.parallel import build_mesh, data_sharding

GRAD = dict(rtol=2e-4, atol=2e-5)
MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4}]
NUM_HEADS = 4


def _arch(hd):
    return dict(image_size=28, patch_size=14, hidden_size=NUM_HEADS * hd, num_layers=2, num_heads=NUM_HEADS,
                mlp_ratio=2)


def _world(hd):
    jcfg = JD.DinoConfig(variant="dinov2", use_layerscale=True, **_arch(hd))
    jp = JD.init_dino(jax.random.PRNGKey(hd), jcfg)
    rng = np.random.default_rng(hd)
    jl = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.02),
                                JL.init_lora(jax.random.PRNGKey(hd + 1), jp, rank=2))
    px = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    w = rng.standard_normal((4, 2, 2, NUM_HEADS * hd)).astype(np.float32)
    return jcfg, jp, jl, px, w


def _jax_grads(jcfg, jp, jl, px, w, mesh_cfg):
    jmesh = jax_build_mesh(mesh_cfg)
    shards = jax_shard_dino_params(jp, jmesh)
    pxs = jax.device_put(jnp.asarray(px), NamedSharding(jmesh, P("data", None, None, None)))

    def loss(lora, x):
        out = JL.lora_forward(jax.lax.stop_gradient(shards), lora, x, jcfg, rank=2, alpha=4.0,
                              tp_shard=(jmesh, "model"))
        return jnp.sum(out["key_features"] * w)

    g_l, g_px = jax.jit(jax.grad(loss, argnums=(0, 1)))(jl, pxs)
    return C.lora_from_jax(jax.tree_util.tree_map(np.asarray, g_l)), np.asarray(g_px)


def _port_grads(params, jl, px, w, tcfg, mesh=None):
    """The adapters' and the pixels' gradients; with ``mesh`` the TP forward
    per data coordinate, its losses added."""
    lora = C.tree_map(lambda t: t.clone().requires_grad_(True), C.lora_from_jax(jax.tree_util.tree_map(np.asarray, jl)))
    x = torch.from_numpy(px).requires_grad_(True)
    wt = torch.from_numpy(w)
    slices = data_sharding(mesh, px.shape[0]) if mesh is not None else [slice(None)]
    kw = {"tp_shard": (mesh, "model")} if mesh is not None else {}
    loss = sum(torch.sum(lora_forward(params, lora, x[sl], tcfg, rank=2, alpha=4.0, **kw)["key_features"] * wt[sl])
               for sl in slices)
    loss.backward()
    return lora, x.grad.numpy()


def _grad_tree(lora):
    """The adapters' gradients, zeros where none reached a leaf (the last
    layer's q and v)."""
    return C.tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, lora)


def _assert_lora_grads(lora, want, what):
    for i, (got_layer, want_layer) in enumerate(zip(_grad_tree(lora), want)):
        for t in ("q", "k", "v"):
            for name in ("a", "b"):
                np.testing.assert_allclose(got_layer[t][name].numpy(), np.asarray(want_layer[t][name]),
                                           err_msg=f"{what} layer {i} {t}.{name}", **GRAD)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("mesh_cfg", MESHES, ids=["data4xmodel2", "data2xmodel4"])
def test_tp_lora_grads_match_jax(mesh_cfg, hd, monkeypatch):
    jcfg, jp, jl, px, w = _world(hd)
    want_l, want_px = _jax_grads(jcfg, jp, jl, px, w, mesh_cfg)
    tcfg = TD.DinoConfig(variant="dinov2", use_layerscale=True, **_arch(hd))
    params = C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    routes = []
    for name in ("packed_attention_diff", "multi_head_attention"):
        orig = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _o=orig, _n=name, **kw: routes.append(_n) or _o(*a, **kw))
    mesh = build_mesh(mesh_cfg, devices=["cpu"] * 8)
    lora, g_px = _port_grads(params, jl, px, w, tcfg, mesh)
    # one attention layer, per data coordinate and model shard: the flash
    # route at 2 heads a shard, the plain one at 1 (as JAX's differentiable_mode)
    tp, n_data = mesh_cfg["model"], mesh_cfg["data"]
    route = "packed_attention_diff" if NUM_HEADS // tp == 2 else "multi_head_attention"
    assert routes == [route] * (tp * n_data)
    np.testing.assert_allclose(g_px, want_px, **GRAD)
    _assert_lora_grads(lora, want_l, "tp")
    monkeypatch.undo()
    un_lora, un_px = _port_grads(params, jl, px, w, tcfg)
    np.testing.assert_allclose(g_px, un_px, **GRAD)
    _assert_lora_grads(lora, _grad_tree(un_lora), "unsharded")
