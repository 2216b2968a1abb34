"""The port's tensor-parallel feature extraction against the JAX package.

``build_mesh``, ``shard_dino_params``, ``tp_multi_head_attention``, the TP
``dino_forward`` and ``FeatureExtractor(mesh=)`` of ``ucod_dpl_tpu_torch``
take the same numpy inputs and weights as their JAX counterparts, which run
on the 8-device CPU mesh as tests/test_tp.py runs them.  The port's meshes
name the CPU eight times (a mesh may name one device more than once), so its
shards run one after another.  Tolerances are those of tests/test_tp.py:
rtol 1e-4 / atol 1e-5 for the forward, 1e-5 / 1e-6 for attention, 2e-4 /
2e-5 for the extractor; the CLS attention path (the pseudo-label
generator's input) tests/test_torch_pseudo_label.py's 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ucod_dpl_tpu.config import CfgNode as JaxCfgNode
from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor as JaxFeatureExtractor
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.ops import attention as JA
from ucod_dpl_tpu.parallel import build_mesh as jax_build_mesh
from ucod_dpl_tpu.parallel.tp import shard_dino_params as jax_shard_dino_params
from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.ops import attention as TA
from ucod_dpl_tpu_torch.ops.quant import quantize_dino_linears
from ucod_dpl_tpu_torch.parallel import build_mesh, data_sharding
from ucod_dpl_tpu_torch.parallel.tp import shard_dino_params

ARCH = dict(image_size=28, patch_size=14, hidden_size=128, num_layers=2, num_heads=8, mlp_ratio=2)
CFG = JD.DinoConfig(variant="dinov2", use_layerscale=True, **ARCH)  # tests/test_tp.py's CFG
TCFG = TD.DinoConfig(variant="dinov2", use_layerscale=True, **ARCH)
MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4}]


def _cpu_mesh(mesh_cfg):
    return build_mesh(mesh_cfg, devices=["cpu"] * 8)


def _jax_params(seed):
    jp = JD.init_dino(jax.random.PRNGKey(seed), CFG)
    return jp, C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _pixels(seed, b, hw=28):
    return np.random.default_rng(seed).standard_normal((b, hw, hw, 3)).astype(np.float32)


def _port_tp(shards, mesh, px, **kw):
    """The port's TP forward per data coordinate, concatenated over the batch."""
    outs = [TD.dino_forward(shards[d], torch.from_numpy(px[sl]), TCFG, tp_shard=(mesh, "model"), **kw)
            for d, sl in enumerate(data_sharding(mesh, px.shape[0]))]
    return {k: torch.cat([o[k] for o in outs]).numpy() for k in outs[0]}


@pytest.mark.parametrize("mesh_cfg", MESHES)
def test_tp_dino_forward_matches_jax_tp_forward(mesh_cfg):
    """model=2: 4 heads of 16 per shard; model=4: 2 per shard (K5's route)."""
    jp, tp = _jax_params(0)
    px = _pixels(0, 4)
    jmesh = jax_build_mesh(mesh_cfg)
    fwd = jax.jit(lambda p, x: JD.dino_forward(p, x, CFG, tp_shard=(jmesh, "model"))["key_features"])
    want = np.asarray(fwd(jax_shard_dino_params(jp, jmesh),
                          jax.device_put(jnp.asarray(px), NamedSharding(jmesh, P("data", None, None, None)))))
    mesh = _cpu_mesh(mesh_cfg)
    got = _port_tp(shard_dino_params(tp, mesh), mesh, px)
    assert set(got) == {"key_tokens", "key_features"}
    np.testing.assert_allclose(got["key_features"], want, rtol=1e-4, atol=1e-5)
    unsharded = TD.dino_forward(tp, torch.from_numpy(px), TCFG)
    for key, value in got.items():
        np.testing.assert_allclose(value, unsharded[key].numpy(), rtol=1e-4, atol=1e-5)


# the CLS attention's tolerance: tests/test_torch_pseudo_label.py's
CLS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh_cfg", MESHES)
def test_tp_cls_attention_matches_jax_tp_and_unsharded(mesh_cfg):
    """``want_cls_attention`` under TP: each shard's heads' CLS row (model=2:
    4 heads a shard, model=4: 2), concatenated in shard order, against the
    JAX TP forward (GSPMD) and the port's unsharded forward."""
    jp, tp = _jax_params(4)
    px = _pixels(4, 4)
    jmesh = jax_build_mesh(mesh_cfg)
    fwd = jax.jit(lambda p, x: JD.dino_forward(p, x, CFG, tp_shard=(jmesh, "model"), want_cls_attention=True))
    want = fwd(jax_shard_dino_params(jp, jmesh),
               jax.device_put(jnp.asarray(px), NamedSharding(jmesh, P("data", None, None, None))))
    mesh = _cpu_mesh(mesh_cfg)
    got = _port_tp(shard_dino_params(tp, mesh), mesh, px, want_cls_attention=True)
    unsharded = TD.dino_forward(tp, torch.from_numpy(px), TCFG, want_cls_attention=True)
    assert set(got) == {"key_tokens", "key_features", "cls_attention"}
    assert got["cls_attention"].shape == (4, 8, 5) and got["cls_attention"].dtype == np.float32
    for key, value in got.items():
        np.testing.assert_allclose(value, np.asarray(want[key]), err_msg=key, **CLS_TOL)
        np.testing.assert_allclose(value, unsharded[key].numpy(), err_msg=key, **CLS_TOL)
    np.testing.assert_allclose(got["cls_attention"].sum(-1), 1.0, rtol=1e-5)


def test_tp_dino_forward_refuses_int8_and_differentiation():
    """TP refuses the int8 path; a key fold runs under TP (as JAX allows it):
    the last layer's LN1 on shard 0's device and the whole fold there, equal
    to the unsharded fold; the differentiated forward runs too, equal to the
    unsharded one."""
    _, tp = _jax_params(0)
    mesh = _cpu_mesh({"data": 4, "model": 2})
    shards = shard_dino_params(tp, mesh)[0]
    px = torch.from_numpy(_pixels(0, 1))
    with pytest.raises(ValueError, match="int8"):
        TD.dino_forward(shards, px, TCFG, tp_shard=(mesh, "model"), quant=quantize_dino_linears(tp))
    rng = np.random.default_rng(1)
    fold = (torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(32).astype(np.float32)))
    got = TD.dino_forward(shards, px, TCFG, tp_shard=(mesh, "model"), key_fold=fold)["folded_features"]
    want = TD.dino_forward(tp, px, TCFG, key_fold=fold)["folded_features"]
    assert got.shape == want.shape == (1, 2, 2, 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    # the differentiated forward runs under TP (it once raised): the
    # unsharded differentiated forward's features
    got = TD.dino_forward(shards, px, TCFG, tp_shard=(mesh, "model"), differentiable=True)["key_features"]
    want = TD.dino_forward(tp, px, TCFG, differentiable=True)["key_features"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="shards"):
        TD.dino_forward(shards[:1], px, TCFG, tp_shard=(mesh, "model"))


def test_shard_dino_params_is_the_megatron_split():
    """Column-parallel q/k/v/fc1 rows and biases, row-parallel out/fc2 input
    columns with whole biases, everything else replicated; the shards put
    back together give the params, and a replicated tensor is shared by the
    shards on one device."""
    _, tp = _jax_params(2)
    mesh = _cpu_mesh({"data": 2, "model": 4})
    shards = shard_dino_params(tp, mesh)
    assert len(shards) == 2 and all(len(row) == 4 for row in shards)
    assert shards[0][1] is shards[1][1]  # one device: the same shard
    for i, layer in enumerate(tp["layers"]):
        parts = [row["layers"][i] for row in shards[0]]
        for name in ("q", "k", "v", "fc1"):
            assert parts[0][name]["w"].shape == (layer[name]["w"].shape[0] // 4, 128)
            torch.testing.assert_close(torch.cat([p[name]["w"] for p in parts]), layer[name]["w"], rtol=0, atol=0)
            torch.testing.assert_close(torch.cat([p[name]["b"] for p in parts]), layer[name]["b"], rtol=0, atol=0)
        for name in ("out", "fc2"):
            torch.testing.assert_close(torch.cat([p[name]["w"] for p in parts], dim=1), layer[name]["w"],
                                       rtol=0, atol=0)
            assert all(p[name]["b"] is parts[0][name]["b"] for p in parts)
            torch.testing.assert_close(parts[0][name]["b"], layer[name]["b"], rtol=0, atol=0)
        for name in ("norm1", "norm2"):
            assert all(p[name]["scale"] is parts[0][name]["scale"] for p in parts)
        assert all(p["ls1"] is parts[0]["ls1"] for p in parts)
    assert all(row["pos_embed"] is shards[0][0]["pos_embed"] for row in shards[0])


def test_tp_attention_matches_jax_tp_attention():
    """The shapes of tests/test_tp.py::test_tp_attention_matches_dense: 8
    heads of 16 over model=4, a sharded tensor being the list of its column
    shards."""
    rng = np.random.default_rng(1)
    b, l, nh, hd = 2, 64, 8, 16
    q, k, v = (rng.standard_normal((b, l, nh * hd)).astype(np.float32) for _ in range(3))
    jmesh = jax_build_mesh({"data": 2, "model": 4})
    want = np.asarray(jax.jit(lambda q, k, v: JA.tp_multi_head_attention(
        q, k, v, nh, scale=0.25, mesh=jmesh, axis="model"))(*(jnp.asarray(x) for x in (q, k, v))))
    mesh = _cpu_mesh({"data": 2, "model": 4})
    shards = [list(torch.from_numpy(x).chunk(4, dim=-1)) for x in (q, k, v)]
    got = TA.tp_multi_head_attention(*shards, nh, scale=0.25, mesh=mesh)
    assert len(got) == 4 and got[0].shape == (b, l, nh * hd // 4)
    np.testing.assert_allclose(torch.cat(got, dim=-1).numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        TA.tp_multi_head_attention(*shards, 6, scale=0.25, mesh=mesh)


def test_build_mesh_refuses_partial_coverage_and_a_missing_card(monkeypatch):
    """As tests/test_tp.py::test_build_mesh_refuses_partial_coverage, on a
    list of eight devices; with no list and no CUDA device it raises."""
    devices = ["cpu"] * 8
    with pytest.raises(ValueError, match="device"):
        build_mesh({"data": -1, "model": 3}, devices=devices)  # 3 does not divide 8
    with pytest.raises(ValueError, match="device"):
        build_mesh({"data": 2, "model": 2}, devices=devices)  # covers 4 of 8
    m = build_mesh({"data": -1, "model": 2}, devices=devices)
    assert m.shape == {"data": 4, "model": 2} and m.devices.shape == (4, 2)
    assert m.device(data=3, model=1) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh({"data": 1, "model": 1})


def test_data_sharding_splits_or_replicates_the_batch():
    mesh = _cpu_mesh({"data": 4, "model": 2})
    assert data_sharding(mesh, 8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert data_sharding(mesh, 6) == [slice(None)] * 4  # does not divide: replicated
    assert data_sharding(mesh) == [slice(None)] * 4  # no batch dim
    assert data_sharding(_cpu_mesh({"model": 8}), 3) == [slice(0, 3)]


def _fe_cfg(weights, cls, **arch):
    return cls({"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": weights,
                "arch": {**ARCH, **arch}})


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """One HF-layout checkpoint that both extractors load."""
    _, tp = _jax_params(3)
    path = tmp_path_factory.mktemp("tp") / "dino.safetensors"
    TD.save_hf_checkpoint(str(path), tp, TCFG)
    return str(path)


@pytest.mark.parametrize("mesh_cfg", MESHES)
def test_feature_extractor_mesh_matches_jax_tp_extractor(checkpoint, mesh_cfg):
    """FeatureExtractor(mesh=) against the JAX TP extractor, float32, at a
    batch the data axis splits and at one it does not (replicated)."""
    jfe = JaxFeatureExtractor(_fe_cfg(checkpoint, JaxCfgNode), compute_dtype=jnp.float32, strict=True,
                              mesh=jax_build_mesh(mesh_cfg))
    fe = FeatureExtractor(_fe_cfg(checkpoint, CfgNode), strict=True, mesh=_cpu_mesh(mesh_cfg))
    assert fe.tp_shard is not None and fe.compute_dtype == torch.float32
    assert fe.device == torch.device("cpu")
    for b in (4, 3):
        px = _pixels(b, b, hw=56)
        got = fe.extract(px)
        assert got.shape == (b, 4, 4, 128) and got.dtype == np.float32
        np.testing.assert_allclose(got, jfe.extract(px), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mesh_cfg", MESHES)
def test_feature_extractor_mesh_extract_with_attention_matches_jax(checkpoint, mesh_cfg):
    """``FeatureExtractor(mesh=).extract_with_attention`` (the pseudo-label
    generator's call) against the JAX TP extractor's, float32, at a batch
    the data axis splits and at one it does not."""
    jfe = JaxFeatureExtractor(_fe_cfg(checkpoint, JaxCfgNode), compute_dtype=jnp.float32, strict=True,
                              mesh=jax_build_mesh(mesh_cfg))
    fe = FeatureExtractor(_fe_cfg(checkpoint, CfgNode), strict=True, mesh=_cpu_mesh(mesh_cfg))
    for b in (4, 3):
        px = _pixels(10 + b, b, hw=56)
        got, want = fe.extract_with_attention(px), jfe.extract_with_attention(px)
        for g, w, shape in zip(got, want, ((b, 17, 128), (b, 4, 4, 128), (b, 8, 17))):
            assert g.shape == shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, **CLS_TOL)


def test_feature_extractor_data_mesh_matches_no_mesh(checkpoint):
    """model=1: the batch is split over the data axis, the forward unsharded."""
    px = _pixels(5, 4, hw=56)
    fe = FeatureExtractor(_fe_cfg(checkpoint, CfgNode), mesh=build_mesh({"data": 2, "model": 1},
                                                                        devices=["cpu"] * 2))
    assert fe.tp_shard is None
    plain = FeatureExtractor(_fe_cfg(checkpoint, CfgNode), device="cpu")
    np.testing.assert_allclose(fe.extract(px), plain.extract(px), rtol=1e-6, atol=1e-6)


def test_feature_extractor_mesh_refusals(checkpoint, monkeypatch):
    """Indivisible heads (tests/test_tp.py::test_tp_runner_rejects_indivisible_heads),
    int8 with TP or with a seq axis (which now runs sequence-parallel:
    tests/test_torch_sp.py), and TP across processes."""
    with pytest.raises(ValueError, match="heads"):
        FeatureExtractor(_fe_cfg(checkpoint, CfgNode, num_heads=6), mesh=_cpu_mesh({"data": 2, "model": 4}))
    with pytest.raises(ValueError, match="int8"):
        FeatureExtractor(_fe_cfg(checkpoint, CfgNode), quantize="int8", mesh=_cpu_mesh({"data": 4, "model": 2}))
    with pytest.raises(ValueError, match="int8"):
        FeatureExtractor(_fe_cfg(checkpoint, CfgNode), quantize="int8", mesh=_cpu_mesh({"data": 4, "seq": 2}))
    assert FeatureExtractor(_fe_cfg(checkpoint, CfgNode), mesh=_cpu_mesh({"data": 4, "seq": 2})).sp_shard
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="single-process"):
        FeatureExtractor(_fe_cfg(checkpoint, CfgNode), mesh=_cpu_mesh({"data": 4, "model": 2}))
