"""The port's tensor-parallel forward with the model axis across processes,
several model coordinates a process, against the JAX package's
single-process TP forward.

One group of 2 gloo ranks of two "cards" each
(``maybe_initialize_distributed("cpu", cards=2)``, started by
``test_torch_distributed.run_ranks``) runs ``dino_forward(tp_shard=)`` on
``build_mesh({"model": 4})``, the mesh over the processes: rank 0 holds
shards 0 and 1, rank 1 shards 2 and 3, so each process adds its two
shards' partial sums and the processes add theirs over the model line
(``distributed.model_parallel_sum``: the line's partials gathered and
folded in shard order).  Each rank computes, at tests/test_torch_tp.py's
width (128 hidden, 8 heads: 2 a shard, 2 layers) in float32:

* the key features and tokens, and the CLS attention
  (``want_cls_attention=True``: each process its shards' heads, gathered
  over the line in shard order);
* the differentiated forward's pixel gradients of a seeded loss on the key
  features (the pixels are replicated: every rank holds the whole
  gradient).

They are held against JAX's ``dino_forward(tp_shard=)`` on the 4-device
CPU mesh (and ``jax.grad`` of the same loss) within tests/test_tp.py's
forward tolerance (rtol 1e-4, atol 1e-5), the CLS attention within
tests/test_torch_pseudo_label.py's 1e-5; every rank's outputs equal rank
0's bit for bit, and rank 0's equal the port's one-process forward on a
mesh naming the CPU four times bit for bit (the same f32 fold in the same
order).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.models import dino as JD
from ucod_dpl_tpu.parallel import build_mesh as jax_build_mesh
from ucod_dpl_tpu.parallel.tp import shard_dino_params as jax_shard_dino_params
from ucod_dpl_tpu_torch.models import convert as C

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_distributed import result_lines, run_ranks  # noqa: E402
from test_torch_tp import CFG, TCFG  # noqa: E402

pytestmark = pytest.mark.heavy  # multi-process: excluded from the quick loop

MESH = {"model": 4}
BATCH = 2
KEYS = ("key_features", "key_tokens", "cls_attention", "pixel_grad")

_RANK = '''
import json, sys
import numpy as np
import torch
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.parallel import build_mesh, distributed as D

world_file, out = sys.argv[1], sys.argv[2]
w = torch.load(world_file, weights_only=False)
D.maybe_initialize_distributed("cpu", cards=2)
rank = D.process_index()
px, loss_w = torch.from_numpy(w["pixels"]), torch.from_numpy(w["loss_w"])


def run(mesh):
    out = TD.dino_forward(w["params"], px, w["cfg"], tp_shard=(mesh, "model"), want_cls_attention=True)
    x = px.clone().requires_grad_(True)
    feats = TD.dino_forward(w["params"], x, w["cfg"], tp_shard=(mesh, "model"), differentiable=True)["key_features"]
    torch.sum(feats * loss_w).backward()
    return {**{k: out[k].numpy() for k in ("key_features", "key_tokens", "cls_attention")},
            "pixel_grad": x.grad.numpy()}


mesh = build_mesh(w["mesh"])
got = run(mesh)
np.savez(f"{out}/rank{rank}.npz", **got)
res = {"rank": rank, "model": mesh.local_block()["model"], "tp_traffic": dict(D.tp_traffic)}
if rank == 0:  # the port's one-process forward on the same inputs
    np.savez(f"{out}/one.npz", **run(build_mesh(w["mesh"], devices=["cpu"] * 4)))
D.barrier("end")
print("RESULT " + json.dumps(res))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and outputs, the one-process forward's, and JAX's."""
    out = tmp_path_factory.mktemp("tp_dist")
    jp = JD.init_dino(jax.random.PRNGKey(7), CFG)
    rng = np.random.default_rng(7)
    px = rng.standard_normal((BATCH, 28, 28, 3)).astype(np.float32)
    loss_w = rng.standard_normal((BATCH, 2, 2, 128)).astype(np.float32)
    torch.save({"params": C.dino_from_jax(jax.tree_util.tree_map(np.asarray, jp)), "cfg": TCFG, "pixels": px,
                "loss_w": loss_w, "mesh": MESH}, out / "world.pt")
    res = run_ranks(out, "ranks", _RANK, 2, args=(out / "world.pt", out), timeout=240)
    ranks = [result_lines(o)[0] for _, o in res]

    jmesh = jax_build_mesh(MESH, devices=jax.devices()[:4])
    shards = jax_shard_dino_params(jp, jmesh)

    def fwd(x, **kw):
        return JD.dino_forward(shards, x, CFG, tp_shard=(jmesh, "model"), **kw)

    want = {k: np.asarray(v) for k, v in jax.jit(lambda x: fwd(x, want_cls_attention=True))(jnp.asarray(px)).items()}
    want["pixel_grad"] = np.asarray(jax.jit(jax.grad(
        lambda x: jnp.sum(fwd(x)["key_features"] * loss_w)))(jnp.asarray(px)))
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return ranks, got, dict(np.load(out / "one.npz")), want


def test_ranks_hold_two_model_coordinates_each(runs):
    ranks = runs[0]
    assert [r["model"] for r in ranks] == [[0, 1], [2, 3]]
    for r in ranks:  # the partial sums and keys of every layer went over the line
        assert r["tp_traffic"]["calls"] > 0 and r["tp_traffic"]["bytes"] > 0


@pytest.mark.parametrize("key", KEYS)
def test_model_axis_across_processes_matches_jax_tp_forward(runs, key):
    _, got, _, want = runs
    tol = dict(rtol=1e-5, atol=1e-5) if key == "cls_attention" else dict(rtol=1e-4, atol=1e-5)
    for r, g in enumerate(got):
        assert g[key].shape == want[key].shape and g[key].dtype == np.float32
        np.testing.assert_allclose(g[key], want[key], err_msg=f"rank {r}", **tol)
    if key == "cls_attention":
        assert want[key].shape == (BATCH, 8, 5)
        np.testing.assert_allclose(got[0][key].sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("key", KEYS)
def test_model_axis_across_processes_is_bitwise_across_ranks_and_one_process(runs, key):
    _, got, one, _ = runs
    np.testing.assert_array_equal(got[1][key], got[0][key])
    if key != "pixel_grad":  # the gradient's sums over the line run in another order
        np.testing.assert_array_equal(got[0][key], one[key])
