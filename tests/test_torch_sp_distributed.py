"""The port's sequence parallelism across processes against its one-process
ring and the JAX package's.

Ranks are gloo subprocesses started by ``test_torch_distributed.run_ranks``
(``device="cpu"``): one group of 4 ranks of one "card" each, and one of 2
ranks of two cards each (``maybe_initialize_distributed("cpu", cards=2)``),
so a ``{"seq": 4}`` ring of the second group crosses processes between its
chunks 1 and 2 and 3 and 0 and copies inside each process between 0 and 1
and 2 and 3 (the mixed transport).  Each group runs every layout it serves
once, and the tests read what its ranks wrote.

* Ring attention at f32 with padding (5 tokens padded to 8; at ``seq`` 4 the
  lens are [2, 2, 1, 0]): ``{"seq": 2}`` on 2 ranks, ``{"seq": 4}`` on 4
  ranks and on 2 ranks x 2 chunks; outputs and q/k/v gradients equal the
  one-process ring's (run by rank 0 on the same inputs) bit for bit, and
  JAX ``ring_attention``'s within tests/test_torch_sp.py's RING_TOL and
  GRAD_TOL.
* ``make_lora_train_step(sp_shard=)`` on a mesh over processes,
  tests/test_torch_sp.py's LoRA config and model, 3 steps at remat "none"
  and "layer": ``{"data": 2, "seq": 2}`` on 4 ranks (ring and data both
  cross), on 2 ranks x 2 cards (the JAX multi-process test's layout: the
  ring inside each process), ``{"seq": 2, "data": 2}`` on 2 ranks x 2 cards
  (the ring across the processes, each holding both data coordinates and
  feeding the whole batch) and ``{"seq": 4}`` on 4 ranks, against JAX's
  single-process step on the same mesh shape (the conftest's CPU devices),
  with tests/test_distributed_sp.py's bound (rtol 1e-3, atol 4.5e-4 on the
  decoder and the adapters), the loss at rtol 1e-5 and the LoRA gradient
  norm at 1e-4; every rank's final state is bitwise equal.
* 2D SP x TP over processes, ``{"seq": 2, "model": 2}`` on 4 ranks (the
  model axis across processes: the out-projection's and fc2's partial sums
  added over the model line's subgroup, the last layer's keys gathered over
  it) and on 2 ranks x 2 cards (the model axis inside each process, every
  head shard's k/v in one exchange a hop): ``ring_attention(h_axis=)``'s
  outputs and q/k/v gradients against JAX's one-process 2D ring (RING_TOL,
  GRAD_TOL), and ``dino_forward(sp_shard=, tp_shard=, differentiable=True)``
  against JAX's 2D forward: the key features at tests/test_torch_sp.py's
  FWD_TOL, and the pixel gradients of a loss on them (each rank's those of
  its own chunks, summed over the ring) at GRAD_TOL, equal on the model
  line's replicas.  The LoRA step runs on the same meshes, replicated over
  ``model`` (above).
* Data-parallel ranks that each run the LoRA step on a one-process
  ``{"seq": 2}`` mesh step as the same ranks without a mesh.
* The mesh over processes maps coordinates to processes as the JAX mesh
  over ``jax.distributed`` processes does, and the guards: the extractor
  and the Runner refuse a process-spanning mesh; the LoRA step takes a
  ``model`` axis across processes (it once refused it) and steps as JAX's.
"""

import json
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
from ucod_dpl_tpu_torch.engine import runner as TR
from ucod_dpl_tpu_torch.models import convert as C

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_distributed import result_lines, run_ranks  # noqa: E402
from test_torch_sp import ARCH, CFG, FWD_TOL, GRAD_TOL, RING_TOL, TCFG  # noqa: E402

pytestmark = pytest.mark.heavy  # multi-process: excluded from the quick loop

RING_SHAPE = dict(b=2, l_valid=5, l_pad=8, d=128, nh=8, scale=0.125)
# (name, mesh config, cards per process) of each group's ring and LoRA layouts
RINGS = {4: [("seq4 on 4 ranks", {"seq": 4})], 2: [("seq2 on 2 ranks", {"seq": 2}), ("seq4 on 2x2", {"seq": 4})]}
LORA_LAYOUTS = {4: [("data2xseq2 on 4 ranks", {"data": 2, "seq": 2}), ("seq4 on 4 ranks", {"seq": 4}),
                    ("seq2xmodel2 on 4 ranks", {"seq": 2, "model": 2})],
                2: [("data2xseq2 on 2x2", {"data": 2, "seq": 2}), ("seq2xdata2 on 2x2", {"seq": 2, "data": 2}),
                    ("seq2xmodel2 on 2x2", {"seq": 2, "model": 2})]}
# 2D SP x TP over processes: the model axis across the processes (4 ranks)
# and inside each (2 ranks x 2 cards)
RINGS_2D = {4: [("seq2xmodel2 on 4 ranks", {"seq": 2, "model": 2})],
            2: [("seq2xmodel2 on 2x2", {"seq": 2, "model": 2})]}
MESH_2D = {"seq": 2, "model": 2}
REMATS = ("none", "layer")
STEPS, BATCH = 3, 4
LORA_CFG = {"model_cfg": {"dim": 128, "feature_size": 8, "ema_weight": 0.99, "dis_use_features": False,
                          "lora": {"enable": True, "rank": 2, "alpha": 4.0}},
            "train_cfg": {"merge_method": "dis", "max_epoch": 25, "start_finetune": -5, "lr0": 2e-4,
                          "dis_lr0": 1e-3, "step_lr_gamma": 0.95, "step_lr_size": 25}}

_RANK = '''
import json, sys
import numpy as np
import torch
from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.engine import train_step as TT
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models import dino as TD
from ucod_dpl_tpu_torch.parallel import build_mesh, distributed as D
from ucod_dpl_tpu_torch.parallel import sp as SP

world_file, out, cards = sys.argv[1], sys.argv[2], int(sys.argv[3])
w = torch.load(world_file, weights_only=False)
D.maybe_initialize_distributed("cpu", cards=cards)
rank = D.process_index()
res = {"rank": rank}

# the coordinate -> process map of the JAX mesh over processes
res["layouts"] = {name: build_mesh(cfg).ranks.tolist() for name, cfg in w["layout_probes"]}

# ring attention: each rank its chunks of the same inputs, its chunks' loss
r = w["ring"]
for name, cfg in w["rings"]:
    mesh = build_mesh(cfg)
    n = mesh.shape["seq"]
    mine = mesh.local_block()["seq"]
    c = r["q"].shape[1] // n
    lens = [max(0, min(c, r["l_valid"] - i * c)) for i in range(n)]  # the real keys of each chunk of 8 tokens
    full = [torch.from_numpy(x) for x in (r["q"], r["k"], r["v"])]
    leaves = [[c.clone().requires_grad_(True) for c in (t.chunk(n, dim=1)[i] for i in mine)] for t in full]
    outs = SP.ring_attention(*leaves, r["nh"], scale=r["scale"], kv_lens=lens, mesh=mesh)
    wt = torch.from_numpy(r["w"]).chunk(n, dim=1)
    sum(torch.sum(o * wt[i]) for o, i in zip(outs, mine)).backward()
    got = {"pos": mine, "out": [o.detach().numpy().tolist() for o in outs],
           "grads": [[t.grad.numpy().tolist() for t in ts] for ts in leaves]}
    if rank == 0:  # the one-process ring on the same inputs
        one = build_mesh(cfg, devices=["cpu"] * n)
        leaves = [[c.clone().requires_grad_(True) for c in t.chunk(n, dim=1)] for t in full]
        outs = SP.ring_attention(*leaves, r["nh"], scale=r["scale"], kv_lens=lens, mesh=one)
        sum(torch.sum(o * wt[i]) for i, o in enumerate(outs)).backward()
        got["one_out"] = [o.detach().numpy().tolist() for o in outs]
        got["one_grads"] = [[t.grad.numpy().tolist() for t in ts] for ts in leaves]
    res["ring " + name] = got

# 2D SP x TP over processes: each rank its chunks of its head shards
for name, cfg in w["rings2d"]:
    mesh = build_mesh(cfg)
    n, tp = mesh.shape["seq"], mesh.shape["model"]
    block = mesh.local_block()
    mine, shards = block["seq"], block["model"]
    c = r["q"].shape[1] // n
    lens = [max(0, min(c, r["l_valid"] - i * c)) for i in range(n)]

    def part(t, m, i):
        return t.chunk(tp, dim=-1)[m].chunk(n, dim=1)[i]

    full = [torch.from_numpy(x) for x in (r["q"], r["k"], r["v"])]
    leaves = [[[part(t, m, i).clone().requires_grad_(True) for i in mine] for m in shards] for t in full]
    outs = SP.ring_attention(*leaves, r["nh"], scale=r["scale"], kv_lens=lens, mesh=mesh, h_axis="model")
    wt = torch.from_numpy(r["w"])
    sum(torch.sum(outs[a][b] * part(wt, m, i)) for a, m in enumerate(shards) for b, i in enumerate(mine)).backward()
    res["ring2d " + name] = {"seq": mine, "model": shards, "out": [[o.detach().numpy().tolist() for o in row]
                                                                    for row in outs],
                             "grads": [[[t.grad.numpy().tolist() for t in row] for row in ts] for ts in leaves]}
    px = torch.from_numpy(w["batches"][0][0]).requires_grad_(True)
    feats = TD.dino_forward(w["backbone"], px, w["dino_cfg"], sp_shard=(mesh, "seq"), tp_shard=(mesh, "model"),
                            differentiable=True)["key_features"]
    torch.sum(feats * torch.from_numpy(w["feat_w"])).backward()
    res["fwd2d " + name] = {"features": feats.detach().numpy().tolist(), "pixel_grad": px.grad.numpy().tolist(),
                            "seq": mine, "model": shards}

# the LoRA step on a mesh over processes, each rank fed the global batches
cfg = CfgNode(w["cfg"])
for name, mesh_cfg in w["lora_layouts"]:
    mesh = build_mesh(mesh_cfg)
    for remat in w["remats"]:
        cfg.model_cfg.lora.remat = remat
        state = TT.init_train_state(*w["weights"], cfg.train_cfg, "cpu")
        lora = C.tree_map(lambda t: t.clone().requires_grad_(True), w["lora"])
        lora_opt = TT.make_optimizer(C.tree_leaves(lora), 1e-4, 0.95, 25)
        step = TT.make_lora_train_step(cfg, w["dino_cfg"], torch.float32, sp_shard=(mesh, "seq"))
        aux = [step(state, lora, lora_opt, w["backbone"], torch.from_numpy(px), torch.from_numpy(pl), 0.0, 1.0)
               for px, pl in w["batches"]]
        exp_avg, exp_avg_sq = lora_opt.moments()
        dm, dv = state.opt.moments()
        flat = [t.detach() for t in C.tree_leaves(state.decoder) + C.tree_leaves(state.decoder_ema)
                + C.tree_leaves(lora) + exp_avg + exp_avg_sq + dm + dv]
        np.save(f"{out}/{name} {remat} {rank}.npy", torch.cat([t.reshape(-1) for t in flat]).numpy())
        res[f"lora {name} {remat}"] = {"loss": [float(a["loss"]) for a in aux],
                                       "lora_grad_norm": [float(a["lora_grad_norm"]) for a in aux]}

# data parallel over the world with a one-process seq mesh on each rank:
# each rank its own rows, held against the same ranks' step without a mesh
if w["dp_local"]:
    cfg.model_cfg.lora.remat = "none"
    per = w["batches"][0][0].shape[0] // D.process_count()
    for name, sp in (("local seq2", (build_mesh({"seq": 2}, devices=["cpu"] * 2), "seq")), ("no mesh", None)):
        state = TT.init_train_state(*w["weights"], cfg.train_cfg, "cpu")
        lora = C.tree_map(lambda t: t.clone().requires_grad_(True), w["lora"])
        lora_opt = TT.make_optimizer(C.tree_leaves(lora), 1e-4, 0.95, 25)
        step = TT.make_lora_train_step(cfg, w["dino_cfg"], torch.float32, sp_shard=sp)
        aux = [step(state, lora, lora_opt, w["backbone"], torch.from_numpy(px[rank * per:(rank + 1) * per]),
                    torch.from_numpy(pl[rank * per:(rank + 1) * per]), 0.0, 1.0) for px, pl in w["batches"]]
        flat = [t.detach() for t in C.tree_leaves(state.decoder) + C.tree_leaves(lora)]
        np.save(f"{out}/dp {name} {rank}.npy", torch.cat([t.reshape(-1) for t in flat]).numpy())
        res["dp " + name] = [float(a["loss"]) for a in aux]

# guards: extraction refuses a mesh over processes
try:
    FeatureExtractor(CfgNode(w["fe_cfg"]), mesh=build_mesh({"seq": D.process_count()}))
    res["fe_guard"] = None
except NotImplementedError as e:
    res["fe_guard"] = str(e)
D.barrier("end")
print("RESULT " + json.dumps(res))
'''


def _ring_inputs():
    s = RING_SHAPE
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((s["b"], s["l_pad"], s["d"])).astype(np.float32) for _ in range(3))
    w = rng.standard_normal((s["b"], s["l_pad"], s["d"])).astype(np.float32)
    w[:, s["l_valid"]:] = 0.0  # the padded rows' outputs are sliced off
    return dict(q=q, k=k, v=v, w=w, nh=s["nh"], scale=s["scale"], l_valid=s["l_valid"])


def _lora_world():
    backbone = JD.init_dino(jax.random.PRNGKey(2), CFG)
    lora0 = JL.init_lora(jax.random.PRNGKey(3), backbone, rank=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dec, ema = j_init_decoder(k1, 128), j_init_decoder(k2, 128)
    dis_p, dis_s = j_init_discriminator(jax.random.PRNGKey(1), feature_size=8, feature_dim=128, use_features=False)
    rng = np.random.default_rng(42)
    batches = [(rng.standard_normal((BATCH, 28, 28, 3)).astype(np.float32),
                (rng.random((BATCH, 8, 8, 1)) > 0.5).astype(np.float32)) for _ in range(STEPS)]
    return dict(backbone=backbone, lora=lora0, dec=dec, ema=ema, dis_p=dis_p, dis_s=dis_s, batches=batches)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _feat_w():
    """The weights of the 2D forward's loss on its (4, 2, 2, 128) key
    features."""
    return np.random.default_rng(9).standard_normal((BATCH, 2, 2, 128)).astype(np.float32)


def _jax_lora_run(world, mesh_cfg, remat):
    """JAX's single-process SP LoRA step on ``mesh_cfg`` over the conftest's
    CPU devices: per-step loss and LoRA gradient norm, final decoder and
    adapters."""
    d = json.loads(json.dumps(LORA_CFG))
    d["model_cfg"]["lora"]["remat"] = remat
    opt, dis_opt, lora_opt = (JT.make_optimizer(lr, 0.95, 25) for lr in (2e-4, 1e-3, 1e-4))
    state = JT.TrainState(decoder=world["dec"], decoder_ema=world["ema"], opt_state=opt.init(world["dec"]),
                          dis_params=world["dis_p"], dis_stats=world["dis_s"],
                          dis_opt_state=dis_opt.init(world["dis_p"]), ema_step=jnp.int32(0))
    n = int(np.prod(list(mesh_cfg.values())))
    jmesh = jax_build_mesh(mesh_cfg, devices=jax.devices()[:n])
    step = jax.jit(JT.make_lora_train_step(JCfg(d), opt, lora_opt, CFG, jnp.float32, sp_shard=(jmesh, "seq")))
    lora, lora_state = world["lora"], lora_opt.init(world["lora"])
    losses, norms = [], []
    for px, pl in world["batches"]:
        pxj = jax.device_put(jnp.asarray(px), NamedSharding(jmesh, P("data" if "data" in mesh_cfg else None)))
        state, lora, lora_state, aux = step(state, lora, lora_state, world["backbone"], pxj, jnp.asarray(pl),
                                            jnp.float32(0.0), jnp.float32(1.0))
        losses.append(float(aux["loss"]))
        norms.append(float(aux["lora_grad_norm"]))
    return dict(loss=losses, lora_grad_norm=norms, decoder=C.decoder_from_jax(_np(state.decoder)),
                lora=C.lora_from_jax(_np(lora)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups' results: ``{world: [rank result, ...]}``, their
    LoRA states under ``out``, and the shared world."""
    out = tmp_path_factory.mktemp("sp_dist")
    world = _lora_world()
    dec, ema = C.decoder_from_jax(_np(world["dec"])), C.decoder_from_jax(_np(world["ema"]))
    port = {"cfg": LORA_CFG, "dino_cfg": TCFG,
            "weights": (dec, ema, *C.discriminator_from_jax(_np(world["dis_p"]), _np(world["dis_s"]))),
            "lora": C.lora_from_jax(_np(world["lora"])), "backbone": C.dino_from_jax(_np(world["backbone"])),
            "batches": world["batches"], "ring": _ring_inputs(), "remats": REMATS,
            "fe_cfg": {"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": None, "arch": ARCH}}
    results = {}
    for procs, cards in ((4, 1), (2, 2)):
        probes = [("data2xseq4", {"data": 2, "seq": 4}), ("seq4xdata2", {"seq": 4, "data": 2}),
                  ("data-1xseq2", {"data": -1, "seq": 2})] if cards == 2 else []
        torch.save({**port, "rings": RINGS[procs], "lora_layouts": LORA_LAYOUTS[procs], "layout_probes": probes,
                    "dp_local": procs == 2, "rings2d": RINGS_2D[procs], "feat_w": _feat_w()},
                   out / f"world{procs}.pt")
        res = run_ranks(out, f"ranks{procs}", _RANK, procs, args=(out / f"world{procs}.pt", out, cards), timeout=300)
        results[procs] = [result_lines(o)[0] for _, o in res]
    return results, out, world


def _ring_case(results, name):
    procs = next(p for p, cases in RINGS.items() if any(c[0] == name for c in cases))
    return [r["ring " + name] for r in results[procs]]


ALL_RINGS = [c[0] for cases in RINGS.values() for c in cases]


@pytest.mark.parametrize("name", ALL_RINGS)
def test_process_ring_is_bitwise_the_one_process_ring(runs, name):
    """Every rank's output chunks and q/k/v gradient chunks equal the
    one-process ring's at the same positions bit for bit."""
    ranks = _ring_case(runs[0], name)
    one = ranks[0]
    seen = set()
    for r in ranks:
        for a, i in enumerate(r["pos"]):
            seen.add(i)
            np.testing.assert_array_equal(np.asarray(r["out"][a], np.float32),
                                          np.asarray(one["one_out"][i], np.float32))
            for t in range(3):
                np.testing.assert_array_equal(np.asarray(r["grads"][t][a], np.float32),
                                              np.asarray(one["one_grads"][t][i], np.float32), err_msg=f"d{'qkv'[t]}")
    assert seen == set(range(len(one["one_out"])))


@pytest.mark.parametrize("name", ALL_RINGS)
def test_process_ring_matches_jax(runs, name):
    """The gathered outputs (valid rows) and gradients against JAX's ring on
    the same mesh shape, with the padded keys' gradients exactly 0."""
    r = _ring_inputs()
    mesh_cfg = dict(next(c for cases in RINGS.values() for c in cases if c[0] == name)[1])
    n = mesh_cfg["seq"]
    jmesh = jax_build_mesh(mesh_cfg, devices=jax.devices()[:n])
    valid = jnp.broadcast_to(jnp.arange(r["q"].shape[1]) < r["l_valid"], r["q"].shape[:2])

    def fwd(q, k, v):
        return jax_ring_attention(q, k, v, r["nh"], scale=r["scale"], mesh=jmesh, axis="seq", valid=valid)

    want = np.asarray(jax.jit(fwd)(r["q"], r["k"], r["v"]))
    loss = jax.grad(lambda q, k, v: jnp.sum(fwd(q, k, v) * r["w"]), argnums=(0, 1, 2))
    want_g = jax.jit(loss)(r["q"], r["k"], r["v"])
    chunks = {}
    for rk in _ring_case(runs[0], name):
        for a, i in enumerate(rk["pos"]):
            chunks[i] = (rk["out"][a], [g[a] for g in rk["grads"]])
    out = np.concatenate([np.asarray(chunks[i][0], np.float32) for i in range(n)], axis=1)
    np.testing.assert_allclose(out[:, :r["l_valid"]], want[:, :r["l_valid"]], **RING_TOL)
    for t, wg in enumerate(want_g):
        got = np.concatenate([np.asarray(chunks[i][1][t], np.float32) for i in range(n)], axis=1)
        np.testing.assert_allclose(got, np.asarray(wg), err_msg=f"d{'qkv'[t]}", **GRAD_TOL)
        if t:
            assert np.all(got[:, r["l_valid"]:] == 0.0)


ALL_LORA = [(procs, name, cfg, remat) for procs, cases in LORA_LAYOUTS.items() for name, cfg in cases
            for remat in REMATS]


@pytest.fixture(scope="module")
def jax_lora(runs):
    world = runs[2]
    cache = {}

    def get(mesh_cfg, remat):
        key = (json.dumps(mesh_cfg), remat)
        if key not in cache:
            cache[key] = _jax_lora_run(world, mesh_cfg, remat)
        return cache[key]

    return get


@pytest.mark.parametrize("procs,name,mesh_cfg,remat", ALL_LORA,
                         ids=[f"{name}-{remat}" for _, name, _, remat in ALL_LORA])
def test_sp_lora_step_across_processes_matches_jax(runs, jax_lora, procs, name, mesh_cfg, remat):
    results, out, _ = runs
    ranks = results[procs]
    flats = [np.load(out / f"{name} {remat} {r}.npy") for r in range(procs)]
    for f in flats[1:]:
        np.testing.assert_array_equal(f, flats[0])  # every rank holds the same state
    want = jax_lora(mesh_cfg, remat)
    runs_aux = [r[f"lora {name} {remat}"] for r in ranks]
    # each rank reports its rows' loss: the mean over the ranks is the global batch's
    loss = np.mean([a["loss"] for a in runs_aux], axis=0)
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    for a in runs_aux:
        np.testing.assert_allclose(a["lora_grad_norm"], want["lora_grad_norm"], rtol=1e-4)
    n_dec = sum(t.numel() for t in C.tree_leaves(want["decoder"]))
    n_lora = sum(t.numel() for t in C.tree_leaves(want["lora"]))
    dec, lora = flats[0][:n_dec], flats[0][2 * n_dec:2 * n_dec + n_lora]
    np.testing.assert_allclose(dec, torch.cat([t.reshape(-1) for t in C.tree_leaves(want["decoder"])]).numpy(),
                               rtol=1e-3, atol=4.5e-4)
    np.testing.assert_allclose(lora, torch.cat([t.reshape(-1) for t in C.tree_leaves(want["lora"])]).numpy(),
                               rtol=1e-3, atol=4.5e-4)
    assert not np.array_equal(lora, torch.cat([t.reshape(-1) for t in C.tree_leaves(
        C.lora_from_jax(_np(runs[2]["lora"])))]).numpy())  # the adapters moved


def test_data_parallel_ranks_with_one_process_seq_mesh(runs):
    """Two data-parallel ranks, each stepping on its own rows through a
    one-process ``{"seq": 2}`` mesh (its token gather stays in the process),
    take the steps of the same ranks without a mesh: each rank's loss is
    that of its own rows, and the states are equal on both ranks."""
    results, out, _ = runs
    for r in results[2]:
        np.testing.assert_allclose(r["dp local seq2"], r["dp no mesh"], rtol=1e-5)
    assert not np.allclose(results[2][0]["dp no mesh"], results[2][1]["dp no mesh"])  # the ranks' rows differ
    flats = {name: [np.load(out / f"dp {name} {r}.npy") for r in range(2)] for name in ("local seq2", "no mesh")}
    for f in flats.values():
        np.testing.assert_array_equal(f[1], f[0])
    np.testing.assert_allclose(flats["local seq2"][0], flats["no mesh"][0], rtol=1e-3, atol=4.5e-4)


def test_process_mesh_maps_coordinates_as_jax_does(runs):
    """Under 2 processes of 4 devices, ``{"data": 2, "seq": 4}`` puts each
    process on a data row (the ring inside it) and ``{"seq": 4, "data":
    2}`` splits the ring between them, as jax.distributed's mesh does
    (process 0's devices first, row-major); an axis of -1 takes the
    devices of the processes' ``cards``."""
    for r in runs[0][2]:
        assert r["layouts"]["data2xseq4"] == [[0, 0, 0, 0], [1, 1, 1, 1]]
        assert r["layouts"]["seq4xdata2"] == [[0, 0], [0, 0], [1, 1], [1, 1]]
        # -1: all remaining devices, the group's 2 processes x 2 cards each
        assert r["layouts"]["data-1xseq2"] == [[0, 0], [1, 1]]


def test_guards_across_processes(runs, jax_lora, tmp_path, monkeypatch):
    """The extractor refuses a mesh over processes (in the ranks); the
    LoRA step takes a ``model`` axis across processes, which it once
    refused, and its first step's loss is JAX's on the same mesh shape; the
    Runner refuses a ``seq`` axis over more than one process."""
    want = jax_lora(MESH_2D, "none")["loss"][0]
    for procs in (4, 2):
        for r in runs[0][procs]:
            assert r["fe_guard"] and "single-process" in r["fe_guard"]
        name = next(n for n, cfg in LORA_LAYOUTS[procs] if "model" in cfg)
        loss = np.mean([r[f"lora {name} none"]["loss"][0] for r in runs[0][procs]])
        np.testing.assert_allclose(loss, want, rtol=1e-5)
    monkeypatch.setattr(TR, "process_count", lambda: 2)
    cfg = CfgNode({"work_dir": str(tmp_path), "log_cfg": {}, "tpu_cfg": {"mesh": {"data": 1, "seq": 2}}})
    with pytest.raises(NotImplementedError, match="make_lora_train_step"):
        TR.Runner(cfg, mode="eval", device="cpu")


ALL_2D = [(procs, name) for procs, cases in RINGS_2D.items() for name, _ in cases]


@pytest.mark.parametrize("procs,name", ALL_2D, ids=[name for _, name in ALL_2D])
def test_2d_ring_across_processes_matches_jax(runs, procs, name):
    """Each rank's output and q/k/v gradient chunks of its head shards,
    gathered, against JAX's 2D ring on the one-process mesh (valid rows;
    the padded keys' gradients exactly 0)."""
    r = _ring_inputs()
    n, tp = MESH_2D["seq"], MESH_2D["model"]
    jmesh = jax_build_mesh(MESH_2D, devices=jax.devices()[:n * tp])
    valid = jnp.broadcast_to(jnp.arange(r["q"].shape[1]) < r["l_valid"], r["q"].shape[:2])

    def fwd(q, k, v):
        return jax_ring_attention(q, k, v, r["nh"], scale=r["scale"], mesh=jmesh, axis="seq", valid=valid,
                                  h_axis="model")

    want = np.asarray(jax.jit(fwd)(r["q"], r["k"], r["v"]))
    want_g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fwd(q, k, v) * r["w"]), argnums=(0, 1, 2)))(
        r["q"], r["k"], r["v"])
    out, grads = {}, {}
    for rk in runs[0][procs]:
        res = rk["ring2d " + name]
        for a, m in enumerate(res["model"]):
            for b, i in enumerate(res["seq"]):
                out[m, i] = np.asarray(res["out"][a][b], np.float32)
                grads[m, i] = [np.asarray(res["grads"][t][a][b], np.float32) for t in range(3)]
    assert set(out) == {(m, i) for m in range(tp) for i in range(n)}

    def whole(parts):
        return np.concatenate([np.concatenate([parts[m, i] for i in range(n)], axis=1) for m in range(tp)], axis=-1)

    v = r["l_valid"]
    np.testing.assert_allclose(whole(out)[:, :v], want[:, :v], **RING_TOL)
    for t, wg in enumerate(want_g):
        got = whole({key: g[t] for key, g in grads.items()})
        np.testing.assert_allclose(got, np.asarray(wg), err_msg=f"d{'qkv'[t]}", **GRAD_TOL)
        if t:
            assert np.all(got[:, v:] == 0.0)


@pytest.mark.parametrize("procs,name", ALL_2D, ids=[name for _, name in ALL_2D])
def test_2d_forward_across_processes_matches_jax(runs, procs, name):
    """The differentiated 2D forward over processes: every rank's key
    features equal JAX's 2D forward; the pixel gradients of its loss, each
    rank's over its own chunks, summed over one model coordinate's ranks,
    equal jax.grad of the same loss, and each model coordinate's sum is the
    same (the replicas hold whole gradients)."""
    world = runs[2]
    px, w = world["batches"][0][0], _feat_w()
    jmesh = jax_build_mesh(MESH_2D, devices=jax.devices()[:4])
    jp = jax_shard_dino_params(world["backbone"], jmesh)

    def feats(x):
        return JD.dino_forward(jp, x, CFG, sp_shard=(jmesh, "seq"), tp_shard=(jmesh, "model"))["key_features"]

    want = np.asarray(jax.jit(feats)(jnp.asarray(px)))
    want_g = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(feats(x) * w)))(jnp.asarray(px)))
    ranks = [r["fwd2d " + name] for r in runs[0][procs]]
    for r in ranks:
        np.testing.assert_allclose(np.asarray(r["features"], np.float32), want, **FWD_TOL)
    sums = {}
    for r in ranks:
        for m in r["model"]:
            sums[m] = sums.get(m, 0.0) + np.asarray(r["pixel_grad"], np.float32)
    assert sorted(sums) == list(range(MESH_2D["model"]))
    for m, g in sums.items():
        np.testing.assert_allclose(g, want_g, err_msg=f"model {m}", **GRAD_TOL)
