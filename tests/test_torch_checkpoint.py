"""The port's full training-state checkpoints and preemption against the JAX
package.

The state file: the port writes exactly the JAX package's keys, dtypes and
shapes (``save_mode="all"`` and preemption saves), and either package
resumes the other's ``state_epochN`` to the end of the run within the
tolerances of tests/test_torch_train_loop.py (the JAX package's own against
the reference loop), while the port's resume of its own file is bitwise.
The atomic save and the embedded metadata are tested as
tests/test_checkpoint_resume.py tests them.  Preemption, mirroring
tests/test_preempt_resume_bitwise.py: mid-train, mid-discriminator, at a
boundary save with validation pending, and mid-train with LoRA on (the
adapters' file beside the state), each resumed bitwise equal to the
port's uninterrupted run (the port's Runner on the tiny 2-layer backbone of
tests/test_torch_eval.py, 8 shuffled images in 4 batches), with the
metadata the JAX TrainLoop writes at the same point.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

from ucod_dpl_tpu.config import CfgNode as JCfg
from ucod_dpl_tpu.engine import checkpoint as JCK
from ucod_dpl_tpu.engine import preempt as JP
from ucod_dpl_tpu.engine.train_loop import TrainLoop as JLoop
from ucod_dpl_tpu_torch.config import CfgNode as TCfg
from ucod_dpl_tpu_torch.engine import checkpoint as TCK
from ucod_dpl_tpu_torch.engine import preempt as TP
from ucod_dpl_tpu_torch.engine.runner import Runner as TRunner
from ucod_dpl_tpu_torch.engine.train_loop import TrainLoop as TLoop
from ucod_dpl_tpu_torch.models import convert as C

from test_torch_eval import _cfg_dict, _make_dataset
from test_torch_train_loop import (
    JaxRunner,
    PortRunner,
    assert_state_close,
    make_batches,
    np_tree,
    run_loop,
    shared_weights,
    train_cfg_dict,
    write_pseudo_labels,
)


def _files(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape) for k in data.files if k != "__meta_json__"}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both packages' uninterrupted 5-epoch runs with ``save_mode="all"``
    every 2 epochs (state_epoch2, state_epoch4), from the same weights and
    batches."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = train_cfg_dict(save_cfg={"start_save": 0, "save_interval": 2, "save_mode": "all"})
    weights, batches = shared_weights(), make_batches()
    jl = JLoop(JCfg(cfg), JaxRunner(weights, batches, root / "jax"))
    tl = TLoop(TCfg(cfg), PortRunner(weights, batches, root / "port"))
    return dict(root=root, cfg=cfg, weights=weights, batches=batches, jloss=run_loop(jl), tloss=run_loop(tl),
                jl=jl, tl=tl)


def test_state_files_have_the_jax_package_keys_dtypes_and_shapes(saved):
    """state_epoch2 and state_epoch4 (after the finetune switch) of the
    port against the JAX package's: the same keys, dtypes and shapes, the
    same metadata; the port's tree of a JAX state maps back to it bit for
    bit."""
    root = saved["root"]
    for name in ("state_epoch2", "state_epoch4"):
        port, jax_ = _files(root / "port" / f"{name}.npz"), _files(root / "jax" / f"{name}.npz")
        assert port == jax_, set(port) ^ set(jax_)
        assert "opt_state/0/mu/decoupling_w" in port and port["ema_step"] == (np.dtype(np.int32), ())
        assert port["opt_state/2/count"] == (np.dtype(np.int32), ())
        with open(root / "port" / f"{name}.json") as f, open(root / "jax" / f"{name}.json") as g:
            assert json.load(f) == json.load(g)
    jstate = np_tree(saved["jl"].state)
    port = C.train_state_from_jax(jstate, TCfg(saved["cfg"]).train_cfg, "cpu")
    # every tensor C-contiguous, moments too: a strided copy of a transposed
    # JAX weight rounds its products otherwise, and a resume is then not bitwise
    leaves = [t for tree in (port.decoder, port.decoder_ema, port.dis_params, port.dis_stats) for t in C.tree_leaves(tree)]
    leaves += [m for opt in (port.opt, port.dis_opt) for ms in opt.moments() for m in ms]
    assert all(t.is_contiguous() for t in leaves)
    back = C.train_state_to_jax(port)
    want = JCK._flatten_with_paths(jstate)
    got = TCK.flatten_with_paths(back)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("direction", ["jax_file_resumed_by_the_port", "port_file_resumed_by_jax"])
def test_state_epoch_resumes_across_packages(saved, direction, tmp_path):
    """Resume from the other package's state_epoch2 to epoch 5 (the finetune
    switch, the second discriminator pass and 12 steps on the restored
    optimizers): the result is within the JAX package's tolerances of the
    writer's own resume, and the port's resume of its own file is bitwise
    its uninterrupted run."""
    root, weights, batches = saved["root"], saved["weights"], saved["batches"]

    def resume(loop_cls, cfg_cls, runner_cls, src, out):
        cfg = dict(saved["cfg"], train_cfg={**saved["cfg"]["train_cfg"], "resume": str(root / src / "state_epoch2")})
        loop = loop_cls(cfg_cls(cfg), runner_cls(weights, batches, tmp_path / out))
        assert loop.start_epoch == 2 and not loop.finetune
        return loop, run_loop(loop)

    if direction == "jax_file_resumed_by_the_port":
        ref, ref_losses = resume(JLoop, JCfg, JaxRunner, "jax", "j")
        got, got_losses = resume(TLoop, TCfg, PortRunner, "jax", "t")
        np.testing.assert_allclose(got_losses, ref_losses, rtol=5e-5, atol=2e-5)
        assert_state_close(got.state, ref.state, "port from the JAX file")
    else:
        ref, ref_losses = resume(TLoop, TCfg, PortRunner, "port", "t")
        got, got_losses = resume(JLoop, JCfg, JaxRunner, "port", "j")
        np.testing.assert_allclose(got_losses, ref_losses, rtol=5e-5, atol=2e-5)
        assert_state_close(ref.state, got.state, "JAX from the port file")
        # the port's own resume: bitwise its uninterrupted run
        assert ref_losses == saved["tloss"][2 * 4:]
        a, b = C.train_state_to_jax(ref.state), C.train_state_to_jax(saved["tl"].state)
        fa, fb = TCK.flatten_with_paths(a), TCK.flatten_with_paths(b)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k


def test_npz_save_is_atomic_and_meta_embedded(saved, tmp_path):
    """As tests/test_checkpoint_resume.py: no temp file left, the embedded
    metadata wins over a stale sidecar and serves without one; a JAX-written
    file reads the same; missing keys raise; the orbax backend and an
    ``.orbax`` directory newer than the ``.npz`` raise NotImplementedError."""
    state = C.train_state_to_jax(saved["tl"].state)
    path = str(tmp_path / "state")
    TCK.save_train_state(path, state, {"epoch": 3, "batch_done": 2})
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
    with open(path + ".json", "w") as f:
        json.dump({"epoch": 999}, f)
    _, meta = TCK.load_train_state(path, state)
    assert meta == {"epoch": 3, "batch_done": 2}
    os.unlink(path + ".json")
    got, meta = TCK.load_train_state(path, state)
    assert meta["epoch"] == 3
    flat, flat_got = TCK.flatten_with_paths(state), TCK.flatten_with_paths(got)
    assert all(np.array_equal(flat[k], flat_got[k]) and flat[k].dtype == flat_got[k].dtype for k in flat)
    # the JAX package's writer, the port's reader, and back
    JCK.save_train_state(str(tmp_path / "j"), np_tree(saved["jl"].state), {"epoch": 5, "phase": "dis"})
    _, meta = TCK.load_train_state(str(tmp_path / "j"), state)
    assert meta == {"epoch": 5, "phase": "dis"}
    _, meta = JCK.load_train_state(path, np_tree(saved["jl"].state))
    assert meta == {"epoch": 3, "batch_done": 2}
    bad = dict(state, decoder={k: v for k, v in state["decoder"].items() if k != "decoupling_b"})
    TCK.save_train_state(str(tmp_path / "bad"), bad, {})
    with pytest.raises(ValueError, match="missing keys"):
        TCK.load_train_state(str(tmp_path / "bad"), state)
    with pytest.raises(NotImplementedError, match="JAX library's format"):
        TCK.save_train_state(path, state, {}, backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        TCK.save_train_state(path, state, {}, backend="zarr")
    os.makedirs(path + ".orbax")
    with pytest.raises(NotImplementedError, match="JAX library's format"):
        TCK.load_train_state(path, state)
    TCK.save_train_state(path, state, {"epoch": 4})  # a save removes the other backend's stale state
    assert not os.path.exists(path + ".orbax")


# ---------------------------------------------------------------------------
# preemption and resume through the port's Runner
# ---------------------------------------------------------------------------


def _preempt_cfg(root, enable_val=False, save_interval=100, lora=False):
    """tests/test_preempt_resume_bitwise.py's schedule: 4 epochs of 4
    shuffled batches, discriminator inter-training at epochs 0 and 2, the
    finetune switch at epoch 3, validation every 2 epochs from epoch 2."""
    _make_dataset(root / "RefCOD", n=8)
    write_pseudo_labels(root / "cache_run", root / "RefCOD", "TINY")
    d = _cfg_dict(root, "run", root / "no-weights")
    d["train_cfg"] = {"max_epoch": 4, "start_finetune": -1, "merge_method": "dis", "merge_alpha": 0.5,
                      "start_epoch": 0, "lr0": 2e-4, "dis_lr0": 1e-3, "dis_intertrain": 2, "dis_epoch": 1,
                      "step_lr_size": 25, "step_lr_gamma": 0.95,
                      "save_cfg": {"save_mode": "all", "save_interval": save_interval, "start_save": 0}}
    d["val_cfg"].update(enable_val=enable_val, val_interval=2, start_val=2)
    if lora:
        d["model_cfg"]["lora"] = {"enable": True, "rank": 2, "alpha": 4.0, "lr": 1e-4, "remat": "none"}
    return d


def _final(runner):
    return [t.numpy().copy() for tree in (runner.decoder_params, runner.decoder_ema_params)
            for t in C.tree_leaves(tree)] + [t.numpy().copy() for t in C.tree_leaves(runner.discriminator_params)]


def _run_port(root, cfg, kind=None, target=0):
    """The port's Runner and TrainLoop on ``cfg``; with ``kind``, the
    preemption flag is raised after the ``target``-th call of the decoder
    step, the discriminator step, or the boundary model save.  Returns the
    loop, or (the preemption metadata, the resumed loop)."""
    runner = TRunner(TCfg(cfg), mode="train", device="cpu")
    loop = TLoop(runner.cfg, runner)
    if kind is None:
        run_loop(loop)
        return loop, runner
    holder, attr = (runner, "save_checkpoint") if kind == "boundary_save" else (
        loop, {"train": "_train_step", "dis": "_dis_step", "lora": "_lora_step"}[kind])
    orig, calls = getattr(holder, attr), {"n": 0}

    def wrapped(*a, **k):
        out = orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == target:
            TP._signum = signal.SIGTERM
        return out

    setattr(holder, attr, wrapped)
    with pytest.raises(SystemExit) as e:
        run_loop(loop)
    assert e.value.code == 128 + signal.SIGTERM
    state_path = os.path.join(runner.ckp_dir, "state_preempt")
    _, meta = TCK.load_train_state(state_path, C.train_state_to_jax(loop.state))
    cfg2 = TCfg(cfg)
    cfg2.train_cfg.resume = state_path
    runner2 = TRunner(cfg2, mode="train", device="cpu")
    loop2 = TLoop(runner2.cfg, runner2)
    run_loop(loop2)
    return meta, loop2, runner2


def _jax_meta(tmp_path, kind, target, enable_val, save_interval):
    """The metadata the JAX TrainLoop writes when preempted at the same
    point of the same schedule (4 batches an epoch)."""
    cfg = train_cfg_dict(max_epoch=4, start_finetune=-1, step_lr_size=25, dis_step_lr_size=25,
                         save_cfg={"save_mode": "all", "save_interval": save_interval, "start_save": 0})
    cfg["val_cfg"] = {"enable_val": enable_val, "val_interval": 2, "start_val": 2}
    runner = JaxRunner(shared_weights(), make_batches(), tmp_path / "jax_preempt")
    loop = JLoop(JCfg(cfg), runner)
    holder, attr = (runner, "save_checkpoint") if kind == "boundary_save" else (
        loop, {"train": "_train_step", "dis": "_dis_step"}[kind])
    orig, calls = getattr(holder, attr), {"n": 0}

    def wrapped(*a, **k):
        out = orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == target:
            JP._signum = signal.SIGTERM
        return out

    setattr(holder, attr, wrapped)
    with pytest.raises(SystemExit):
        run_loop(loop)
    with open(tmp_path / "jax_preempt" / "state_preempt.json") as f:
        return json.load(f)


@pytest.mark.parametrize("kind,target,enable_val,save_interval,want", [
    # epochs 0 and 1 take 8 decoder steps: the 10th is epoch 2's second
    ("train", 10, False, 100, {"phase": "train", "dis_pass": 0, "batch_done": 2, "epoch": 2}),
    # epoch 0's discriminator pass takes 4 steps: the 6th is epoch 2's second
    ("dis", 6, False, 100, {"phase": "dis", "dis_pass": 0, "batch_done": 2, "epoch": 2}),
    # the first boundary save is epoch 2's, before its validation
    ("boundary_save", 1, True, 2, {"epoch": 2, "val_pending": True}),
    # the LoRA branch at the 10th LoRA step: the adapters and their optimizer
    # resume from the state_preempt_lora file beside the state
    ("lora", 10, False, 100, {"phase": "train", "dis_pass": 0, "batch_done": 2, "epoch": 2}),
])
def test_preempted_run_resumes_bitwise(tmp_path, kind, target, enable_val, save_interval, want):
    """Preempt, save ``state_preempt`` with the phase reached, exit
    128 + SIGTERM, resume in a fresh Runner: the final decoder, EMA and
    discriminator (and adapters) equal the uninterrupted run's bit for bit
    (and best-MAE tracking too, where the resume ran the pending
    validation), and the metadata is what the JAX package writes at the same
    point."""
    lora = kind == "lora"
    ref_loop, ref_runner = _run_port(tmp_path / "a", _preempt_cfg(tmp_path / "a", enable_val, save_interval, lora))
    meta, loop, runner = _run_port(tmp_path / "b", _preempt_cfg(tmp_path / "b", enable_val, save_interval, lora),
                                   kind, target)
    assert {k: meta[k] for k in want} == want and meta["finetune"] is False
    if kind == "boundary_save":
        assert not meta.get("phase") and np.isfinite(ref_loop.best_mae) and loop.best_mae == ref_loop.best_mae
    assert meta == _jax_meta(tmp_path, "train" if lora else kind, target, enable_val, save_interval)
    for i, (a, b) in enumerate(zip(_final(runner), _final(ref_runner), strict=True)):
        assert np.array_equal(a, b), i
    assert loop.state.opt.count == ref_loop.state.opt.count and loop.state.ema_step == ref_loop.state.ema_step
    if lora:
        assert os.path.exists(os.path.join(runner.ckp_dir, "state_preempt_lora.npz"))
        for a, b in zip(C.tree_leaves(loop.lora_params), C.tree_leaves(ref_loop.lora_params), strict=True):
            assert torch.equal(a, b)
        assert loop.lora_opt.count == ref_loop.lora_opt.count


def test_requested_global_is_the_local_flag_in_one_process(monkeypatch):
    """The preemption flag every process agrees on: this process's own in a
    run of one, with no collective.  The process group decides, not the
    launcher's variables: with ``WORLD_SIZE=2`` set but no group started,
    the answer is still the local flag and ``GlobalPoll`` is a per-batch
    check (the gloo agreement of more than one process is
    tests/test_torch_distributed.py's)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    TP.clear()
    assert TP.requested_global() is None
    TP._signum = signal.SIGTERM
    try:
        assert TP.requested_global() == signal.SIGTERM
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert not torch.distributed.is_initialized()
        assert TP.requested_global() == signal.SIGTERM
        poll = TP.GlobalPoll(5, every=2)
        assert poll.single and poll.rounds_total == 0
        with pytest.raises(TP.Preempted):
            poll.step()
        assert not torch.distributed.is_initialized()
    finally:
        TP.clear()
