"""Data-parallel stage-1 training of the port over 2 gloo ranks on the CPU,
against the JAX package's single-process step fed the global batch.

The JAX package's own oracles fix what a data-parallel step is: the global
batch is the ranks' local batches concatenated in rank order, the gradient
is that of the mean loss over it, and the discriminator's batch-norm
moments are taken over it.  So 2 ranks x local batch 2 are held against one
JAX process stepping on batches of 4 (its multi-process ``cli train`` is no
oracle: its ``_device_batch`` puts each process's own batch on the global
mesh, which jax refuses).  The ranks must end bitwise equal; the states
within the tolerances of tests/test_torch_train_loop.py's
``assert_state_close`` (rtol 1e-4 / atol 5e-6; the learnable embedding,
whose gradient is rounding noise that AdamW turns into steps of up to lr,
by its median and maximum drift), and a variant whose ranks take their
batch-norm moments over their own batch must fall outside them.  The LoRA
step at the tiny ViT width of ``test_lora_branch_matches_jax_for_2_epochs``
holds the adapters within its rtol 1e-4 / atol 1e-5.  Then ``cli train``
over 2 ranks with SIGTERM to one rank: both exit at the same agreed batch,
process 0 writes ``state_preempt``, and the resumed 2-rank run ends bitwise
equal to the uninterrupted one.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.engine import train_step as JT
from ucod_dpl_tpu.models import lora as JL
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.engine import checkpoint as TCK
from ucod_dpl_tpu_torch.engine import train_step as TT
from ucod_dpl_tpu_torch.models import convert as C
from ucod_dpl_tpu_torch.models.dba import rev_decoder_forward

from test_torch_distributed import result_lines, run_ranks
from test_torch_train_loop import (
    FS,
    LORA_ARCH,
    _lora_cfg_dict,
    _lora_world,
    _tiny_train_config,
    _train_argv,
    assert_state_close,
    make_batches,
    np_tree,
    shared_weights,
    train_cfg_dict,
    write_pseudo_labels,
)
from test_torch_eval import _make_dataset

pytestmark = pytest.mark.heavy  # multi-process: excluded from the quick loop

_STEPS = '''
import sys
import torch
from ucod_dpl_tpu_torch.config import CfgNode
from ucod_dpl_tpu_torch.engine import checkpoint as TCK, train_step as TT
from ucod_dpl_tpu_torch.models import convert as C, discriminator as TDis
from ucod_dpl_tpu_torch.parallel import distributed as D

world_file, out = sys.argv[1:3]
D.maybe_initialize_distributed("cpu")
rank = D.process_index()
w = torch.load(world_file, weights_only=False)
cfg = CfgNode(w["cfg"])
local = slice(2 * rank, 2 * rank + 2)  # rank r holds rows 2r, 2r + 1 of each global batch of 4
if "lora" in w:
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    fe = FeatureExtractor(CfgNode(w["fe_cfg"]), device="cpu", compute_dtype=torch.float32, strict=True,
                          qkv_masters=True)
    state = TT.init_train_state(*w["weights"], cfg.train_cfg, "cpu")
    lora = C.tree_map(lambda t: t.requires_grad_(True), w["lora"])
    lora_opt = TT.make_lora_optimizer(lora, cfg)
    step = TT.make_lora_train_step(cfg, fe.config, fe.compute_dtype)
    for px, pl in w["batches"]:
        step(state, lora, lora_opt, fe.params, torch.from_numpy(px[local]), torch.from_numpy(pl[local]), 0.0, 1.0)
    TCK.save_train_state(f"{out}/lora{rank}", C.lora_state_to_jax(lora, lora_opt), {})
    TCK.save_train_state(f"{out}/state{rank}", C.train_state_to_jax(state), {})
else:
    for variant in ("state", "local_bn"):
        if variant == "local_bn":  # the fault to catch: each rank normalises by its own batch's moments
            TDis._global_moments = lambda y, group=None: TDis._local_moments(y)
        state = TT.init_train_state(*w["weights"], cfg.train_cfg, "cpu")
        dis_step, step = TT.make_discriminator_step(cfg), TT.make_train_step(cfg)
        for f, pl in w["batches"]:  # one discriminator pass, then the stage-1 steps
            dis_step(state, torch.from_numpy(f[local]), torch.from_numpy(pl[local]))
        for i, (f, pl) in enumerate(w["batches"]):
            step(state, torch.from_numpy(f[local]), torch.from_numpy(pl[local]), float(i), 1.0)
        TCK.save_train_state(f"{out}/{variant}{rank}", C.train_state_to_jax(state), {})
print("RESULT {}")
'''


def _port_weights(weights):
    dec, ema, dis_p, dis_s = weights
    return (C.decoder_from_jax(dec), C.decoder_from_jax(ema), *C.discriminator_from_jax(dis_p, dis_s))


def _jax_state(weights, tc):
    dec, ema, dis_p, dis_s = jax.tree_util.tree_map(jnp.asarray, weights)
    tx = JT.make_optimizer(tc["lr0"], tc["step_lr_gamma"], tc["step_lr_size"])
    dis_tx = JT.make_optimizer(tc["dis_lr0"], tc["dis_step_lr_gamma"], tc["dis_step_lr_size"])
    state = JT.TrainState(decoder=dec, decoder_ema=ema, opt_state=tx.init(dec), dis_params=dis_p, dis_stats=dis_s,
                          dis_opt_state=dis_tx.init(dis_p), ema_step=jnp.zeros((), jnp.int32))
    return state, tx, dis_tx


def _rank_states(out, cfg, template, prefix="state"):
    """Each rank's saved state as a port TrainState, and its flat arrays."""
    states, flats = [], []
    for rank in range(2):
        tree, _ = TCK.load_train_state(str(out / f"{prefix}{rank}"), C.train_state_to_jax(template))
        states.append(C.train_state_from_jax(tree, TCfg(cfg).train_cfg, "cpu"))
        flats.append(TCK.flatten_with_paths(tree))
    return states, flats


def _binarise_margin(jstate, f, pl):
    """The smallest ``|p - 0.5|`` over what a step on the batch ``(f, pl)``
    binarises at ``0.5`` from ``jstate``: the student's and the teacher's
    ``sigmoid(fg)`` and the pseudo-labels, at the feature size.  A value
    this close to the threshold would flip its mask on a last-bit change
    in the moments' order of summation, and such a flip moves a state by
    far more than the tolerance."""
    ft = TT._to_feature_size(torch.from_numpy(f), FS)
    probs = [torch.sigmoid(rev_decoder_forward(C.decoder_from_jax(np_tree(d)), ft, with_loss=False)[0])
             for d in (jstate.decoder, jstate.decoder_ema)]
    probs.append(TT._to_feature_size(torch.from_numpy(pl), FS))
    return min(float((p - 0.5).abs().min()) for p in probs)


def _assert_bitwise(flats):
    assert set(flats[0]) == set(flats[1])
    for k in flats[0]:
        assert np.array_equal(flats[0][k], flats[1][k]), k


def test_two_ranks_step_as_one_process_on_the_global_batch(tmp_path):
    """One discriminator pass and three stage-1 steps (``merge_method``
    dis, the discriminator's feature branch on) over 3 global batches of 4
    on 2 ranks: bitwise equal ranks, the JAX step's state on the
    concatenated batches; rank-local batch-norm moments are caught.  No
    value these steps binarise lies near its threshold."""
    cfg = train_cfg_dict()
    weights = shared_weights()
    halves = make_batches(seed=5, n=6)
    batches = [(np.concatenate([a["features"], b["features"]]), np.concatenate([a["pseudo_label"], b["pseudo_label"]]))
               for a, b in zip(halves[0::2], halves[1::2])]
    torch.save({"cfg": cfg, "weights": _port_weights(weights), "batches": batches}, tmp_path / "world.pt")

    jstate, tx, dis_tx = _jax_state(weights, cfg["train_cfg"])
    jcfg = TCfg(cfg)
    dis_step, step = jax.jit(JT.make_discriminator_step(jcfg, dis_tx)), jax.jit(JT.make_train_step(jcfg, tx))
    margins = []
    for f, pl in batches:
        margins.append(_binarise_margin(jstate, f, pl))
        jstate, _ = dis_step(jstate, jnp.asarray(f), jnp.asarray(pl))
    for i, (f, pl) in enumerate(batches):
        margins.append(_binarise_margin(jstate, f, pl))
        jstate, _ = step(jstate, jnp.asarray(f), jnp.asarray(pl), jnp.float32(i), jnp.float32(1.0))
    # no mask of these steps lies within 1e-4 of its threshold (the ranks'
    # and the JAX step's probabilities differ by far less, checked below),
    # so the comparison is not decided by where the data puts a near-0.5 value
    assert min(margins) > 1e-4, margins

    run_ranks(tmp_path, "steps", _STEPS, 2, args=(tmp_path / "world.pt", tmp_path))
    template = TT.init_train_state(*_port_weights(weights), jcfg.train_cfg, "cpu")
    states, flats = _rank_states(tmp_path, cfg, template)
    _assert_bitwise(flats)
    for st in states:
        assert_state_close(st, jstate, "2 ranks")
    with torch.no_grad():
        gap = max(float((torch.sigmoid(rev_decoder_forward(st, ft, with_loss=False)[0])
                         - torch.sigmoid(rev_decoder_forward(C.decoder_from_jax(np_tree(jt)), ft, with_loss=False)[0])
                         ).abs().max())
                  for f, _ in batches for ft in [TT._to_feature_size(torch.from_numpy(f), FS)]
                  for st, jt in ((states[0].decoder, jstate.decoder), (states[0].decoder_ema, jstate.decoder_ema)))
    assert gap < 1e-5, gap
    local_bn, _ = _rank_states(tmp_path, cfg, template, prefix="local_bn")
    with pytest.raises(AssertionError):
        assert_state_close(local_bn[0], jstate, "rank-local moments")


def test_two_ranks_lora_steps_match_jax_on_the_global_batch(tmp_path, monkeypatch):
    """Two LoRA steps on 2 ranks x 2 images (hidden 128, two heads of 64:
    the JAX attention on its Pallas kernel and flash VJP, in interpret
    mode) against the JAX step on the 4 images: ranks bitwise equal, the
    adapters within rtol 1e-4 / atol 1e-5, decoder and discriminator as in
    the cached step."""
    monkeypatch.setenv("UCOD_PALLAS_INTERPRET", "1")
    jfe, _, _, weights = _lora_world(tmp_path)
    cfg = _lora_cfg_dict(tmp_path)
    rng = np.random.default_rng(13)
    batches = [(rng.standard_normal((4, 56, 56, 3)).astype(np.float32),
                np.where(rng.random((4, 16, 16, 1)) > 0.5, 0.9, 0.2).astype(np.float32)) for _ in range(2)]
    jlora = JL.init_lora(jax.random.PRNGKey(1), jfe.params, rank=2)
    jlora = [{t: {"a": e["a"], "b": jnp.asarray(0.05 * rng.standard_normal(e["b"].shape), jnp.float32)}
              for t, e in layer.items()} for layer in jlora]
    fe_cfg = {"type": "dinov2", "backbone": "facebook/dinov2-base", "backbone_weights": str(tmp_path / "hf.safetensors"),
              "arch": dict(LORA_ARCH)}
    torch.save({"cfg": cfg, "weights": _port_weights(weights), "batches": batches, "fe_cfg": fe_cfg,
                "lora": C.lora_from_jax(np_tree(jlora))}, tmp_path / "world.pt")

    tc = cfg["train_cfg"]
    jstate, tx, _ = _jax_state(weights, tc)
    ltx = JT.make_optimizer(cfg["model_cfg"]["lora"]["lr"], tc["step_lr_gamma"], tc["step_lr_size"])
    jlopt = ltx.init(jlora)
    jstep = jax.jit(JT.make_lora_train_step(TCfg(cfg), tx, ltx, jfe.config, jnp.float32))
    for px, pl in batches:
        jstate, jlora, jlopt, _ = jstep(jstate, jlora, jlopt, jfe.params, jnp.asarray(px), jnp.asarray(pl),
                                        jnp.float32(0.0), jnp.float32(1.0))

    out = tmp_path / "out"
    out.mkdir()
    run_ranks(tmp_path, "lora", _STEPS, 2, args=(tmp_path / "world.pt", out))
    template = TT.init_train_state(*_port_weights(weights), TCfg(cfg).train_cfg, "cpu")
    states, flats = _rank_states(out, cfg, template)
    _assert_bitwise(flats)
    assert_state_close(states[0], jstate, "LoRA, 2 ranks")
    want = C.lora_from_jax(np_tree(jlora))
    lora_t = C.tree_map(lambda t: t.requires_grad_(True), C.lora_from_jax(np_tree(jlora)))
    lora_template = C.lora_state_to_jax(lora_t, TT.make_lora_optimizer(lora_t, TCfg(cfg)))
    trees = [TCK.load_train_state(str(out / f"lora{r}"), lora_template)[0] for r in range(2)]
    _assert_bitwise([TCK.flatten_with_paths(t) for t in trees])
    got, lora_opt = C.lora_state_from_jax(trees[0], TCfg(cfg), "cpu")
    assert lora_opt.count == 2
    for g, w in zip(C.tree_leaves(got), C._leaves_like(got, want), strict=True):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


_CLI = '''
import json, os, signal, sys
import numpy as np
from ucod_dpl_tpu_torch import cli
from ucod_dpl_tpu_torch.engine import train_loop
from ucod_dpl_tpu_torch.models.convert import tree_leaves

argv, kill_after, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rank = int(os.environ["RANK"])
saves = []
orig_save = train_loop.save_train_state

def counting_save(path, *a, **k):
    saves.append(os.path.basename(path))
    return orig_save(path, *a, **k)

train_loop.save_train_state = counting_save
steps = [0]
orig_make = train_loop.make_train_step

def make(*a, **k):
    inner = orig_make(*a, **k)

    def step(*sa):
        aux = inner(*sa)
        steps[0] += 1
        if rank == 1 and steps[0] == kill_after:  # SIGTERM to this rank alone
            os.kill(os.getpid(), signal.SIGTERM)
        return aux

    return step

train_loop.make_train_step = make
try:
    runner = cli.train_main(argv)
except SystemExit as e:
    print("RESULT " + json.dumps({"exit": e.code, "steps": steps[0], "saves": saves}))
    sys.exit(e.code)
loop = runner.train_loop
trees = (runner.decoder_params, runner.decoder_ema_params, runner.discriminator_params, runner.discriminator_stats)
if loop.lora_enabled:
    trees += (loop.lora_params,)
flat = [t.detach().numpy() for tree in trees for t in tree_leaves(tree)]
np.savez(os.path.join(out, f"final{rank}.npz"), *flat)
print("RESULT " + json.dumps({"exit": 0, "steps": steps[0], "saves": saves, "count": loop.state.opt.count,
                              "best_mae": loop.best_mae}))
'''


def test_cli_train_over_2_ranks_preempts_and_resumes_bitwise(tmp_path):
    """``cli train --device cpu`` over 2 ranks (16 train images: 4 steps of
    2 a rank an epoch; 2 epochs with a discriminator pass, the finetune
    switch and a validation over 3 images, 2 and 1 a rank), the ranks
    agreeing on preemption every 2 batches.  Uninterrupted: both ranks end
    on the same parameters, process 0 alone writes the state.  SIGTERM to
    rank 1 after its 5th decoder step (epoch 1, batch 1): both ranks exit
    143 at batch 2, the next agreement, with ``state_preempt`` from process
    0; the 2-rank ``--resume`` ends bitwise on the uninterrupted run."""
    for name, n in (("TR-A", 8), ("TR-B", 8), ("TE-A", 3)):
        _make_dataset(tmp_path / "RefCOD", name=name, n=n)
    write_pseudo_labels(tmp_path / "cache", tmp_path / "RefCOD", "TR-A+TR-B", shape=(2, 2, 1))
    path = _tiny_train_config(tmp_path, {"preempt_poll_interval": 2})

    def argv(tag, *extra):
        a = _train_argv(tmp_path, path, *extra)[1:]
        a[a.index("--work_dir") + 1] = str(tmp_path / f"wd_{tag}")
        return json.dumps(a)

    runs = {}
    for tag, kill, extra in (("a", 0, ()), ("b", 5, ())):
        out = tmp_path / tag
        out.mkdir()
        runs[tag] = run_ranks(tmp_path, "cli", _CLI, 2, args=(argv(tag, *extra), kill, out), check=tag == "a")
    a = [result_lines(o)[0] for _, o in runs["a"]]
    assert a[0]["saves"] == ["state_epoch2"] and a[1]["saves"] == []
    assert a[0]["count"] == a[1]["count"] == 4 and a[0]["steps"] == a[1]["steps"] == 8
    assert a[0]["best_mae"] == a[1]["best_mae"] and np.isfinite(a[0]["best_mae"])
    finals = [np.load(tmp_path / "a" / f"final{r}.npz") for r in range(2)]
    for k in finals[0].files:
        assert np.array_equal(finals[0][k], finals[1][k]), k

    b = [(rc, result_lines(o)[0]) for rc, o in runs["b"]]
    assert [rc for rc, _ in b] == [143, 143], runs["b"][0][1][-3000:]
    assert b[0][1]["saves"] == ["state_preempt"] and b[1][1]["saves"] == []
    assert b[0][1]["steps"] == b[1][1]["steps"] == 6  # 4 in epoch 0, then batches 1 and 2 of epoch 1
    ckp = tmp_path / "wd_b"
    state = next(ckp.rglob("state_preempt.npz"))
    with open(str(state)[: -len(".npz")] + ".json") as f:
        meta = json.load(f)
    assert {k: meta[k] for k in ("phase", "batch_done", "epoch")} == {"phase": "train", "batch_done": 2, "epoch": 1}

    out = tmp_path / "b_resumed"
    out.mkdir()
    res = run_ranks(tmp_path, "cli", _CLI, 2, args=(argv("b", "--resume", str(state)[: -len(".npz")]), 0, out))
    r = [result_lines(o)[0] for _, o in res]
    assert r[0]["steps"] == r[1]["steps"] == 2 and r[0]["best_mae"] == a[0]["best_mae"]
    for rank in range(2):
        got = np.load(out / f"final{rank}.npz")
        for k in finals[0].files:
            assert np.array_equal(got[k], finals[0][k]), (rank, k)


def test_cli_train_with_lora_over_2_ranks(tmp_path):
    """``cli train --device cpu`` with LoRA over 2 ranks (the adapters
    trained from pixels through the backbone in each rank): the ranks end
    on the same decoder, discriminator and adapters, bit for bit, and
    process 0 alone writes the state pair and the adapter files."""
    for name, n in (("TR-A", 4), ("TR-B", 4), ("TE-A", 1)):
        _make_dataset(tmp_path / "RefCOD", name=name, n=n)
    write_pseudo_labels(tmp_path / "cache", tmp_path / "RefCOD", "TR-A+TR-B", shape=(2, 2, 1))
    path = _tiny_train_config(tmp_path)
    argv = _train_argv(tmp_path, path)[1:] + ["model_cfg.lora.enable", "True", "model_cfg.lora.remat", "none"]
    out = tmp_path / "out"
    out.mkdir()
    res = [result_lines(o)[0] for _, o in run_ranks(tmp_path, "cli", _CLI, 2, args=(json.dumps(argv), 0, out))]
    assert res[0]["saves"] == ["state_epoch2", "state_epoch2_lora"] and res[1]["saves"] == []
    finals = [np.load(out / f"final{r}.npz") for r in range(2)]
    assert len(finals[0].files) > 40  # the adapters are in
    for k in finals[0].files:
        assert np.array_equal(finals[0][k], finals[1][k]), k
    ckp = next((tmp_path / "wd").rglob("lora_epoch2.safetensors")).parent
    assert (ckp / "backbone_merged_epoch2.safetensors").exists()
