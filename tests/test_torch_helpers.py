"""The port's counterparts of the JAX package's sharding helpers and
``patch_transform``, held against the JAX functions on the same inputs.

* ``parallel/tp.py::dino_param_specs``: each leaf's split over ``model``
  (the JAX ``PartitionSpec`` on the JAX ``(in, out)`` layout, the port's
  dimension on its ``(out, in)`` one), and the shards it cuts against the
  JAX sharded params' shards on the 8-device CPU mesh;
* ``parallel/mesh.py::replicate`` and ``shard_batch``: the rows each
  ``data`` coordinate holds against the JAX shardings' shards (a batch that
  divides the axis, one that does not, a scalar);
* ``data/transforms.py::patch_transform``: ToTensor + normalise without a
  resize, equal to the JAX one (f32 arithmetic, 1e-6).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from ucod_dpl_tpu.data import transforms as JTF
from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.parallel import build_mesh as jax_build_mesh
from ucod_dpl_tpu.parallel import mesh as JM
from ucod_dpl_tpu.parallel import tp as JTP
from ucod_dpl_tpu_torch.data import transforms as TTF
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.parallel import build_mesh, replicate, shard_batch
from ucod_dpl_tpu_torch.parallel.tp import dino_param_specs, place_shard

ARCH = dict(image_size=28, patch_size=14, hidden_size=128, num_layers=2, num_heads=8, mlp_ratio=2)


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("layerscale", [True, False], ids=["dinov2", "dinov1"])
def test_dino_param_specs_match_jax(layerscale):
    """The split dimension of every leaf is the JAX spec's, transposed for
    the 2-D weights (JAX (in, out), the port (out, in)); the shards
    ``place_shard`` cuts by it are the JAX sharded params' shards."""
    cfg = JD.DinoConfig(variant="dinov2" if layerscale else "dinov1", use_layerscale=layerscale, **ARCH)
    jp = JD.init_dino(jax.random.PRNGKey(0), cfg)
    params = C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    j_specs = dict(_leaves(JTP.dino_param_specs(jp)))
    specs = _leaves(dino_param_specs(params))
    assert {p for p, _ in specs} == set(j_specs)
    leaves = dict(_leaves(params))
    for path, dim in specs:
        spec = tuple(j_specs[path])
        want = spec.index("model") if "model" in spec else None
        if want is not None and leaves[path].dim() == 2:
            want = 1 - want  # (in, out) -> (out, in)
        assert dim == want, path
    jmesh = jax_build_mesh({"data": 4, "model": 2})
    sharded = dict(_leaves(JTP.shard_dino_params(jp, jmesh)))
    checked = 0
    for m in range(2):
        shard = dict(_leaves(place_shard(params, m, 2, torch.device("cpu"))))
        device = jmesh.devices[0, m]
        for path, t in shard.items():
            ref = np.asarray(next(s.data for s in sharded[path].addressable_shards if s.device == device))
            if path.endswith("/w"):
                ref = ref.T  # the linears' (in, out) -> (out, in)
            elif ref.shape != tuple(t.shape):
                continue  # the patch kernel: HWIO against OIHW, replicated
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=path)
            checked += 1
    assert checked == 2 * (len(shard) - 1)


def _rows_of(sharding, shape, mesh_devices):
    """The rows of a leading dim each data coordinate's first device holds."""
    index = sharding.devices_indices_map(shape)
    return [index[mesh_devices[d, 0]][0] if len(shape) else slice(None) for d in range(mesh_devices.shape[0])]


def test_replicate_matches_jax():
    jmesh = jax_build_mesh({"data": 4, "model": 2})
    mesh = build_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    assert replicate(mesh) == _rows_of(JM.replicate(jmesh), (8, 3), jmesh.devices) == [slice(None)] * 4


def test_shard_batch_matches_jax():
    """A batch of 8 rows splits over ``data`` 4; one of 6 rows does not
    divide it and is replicated; a scalar is replicated."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((8, 3)).astype(np.float32),
             "y": [rng.standard_normal((6, 2)).astype(np.float32), np.float32(2.5)]}
    jmesh = jax_build_mesh({"data": 4, "model": 2})
    j_sharded = JM.shard_batch(batch, jmesh)
    got = shard_batch(batch, build_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8))
    assert len(got) == 4
    for path, arr in _leaves(j_sharded):
        for d in range(4):
            device = jmesh.devices[d, 0]
            want = np.asarray(next(s.data for s in arr.addressable_shards if s.device == device))
            part = dict(_leaves(got[d]))[path]
            assert isinstance(part, torch.Tensor) and part.device.type == "cpu"
            np.testing.assert_array_equal(part.numpy(), want, err_msg=f"{path} data {d}")


def test_patch_transform_matches_jax():
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (37, 53, 3), dtype=np.uint8))
    got, want = TTF.patch_transform(img), JTF.patch_transform(img)
    assert got.shape == want.shape == (37, 53, 3) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
