"""Randomized preemption soak of the port's training entry: SIGTERM
``cli train`` at random wall-clock offsets, resume, and require every cycle
to end cleanly.

Counterpart of the JAX package's ``scripts/soak_preempt.py``.  The port's
preemption tests stop at fixed points; a SIGTERM that lands inside a kernel
launch, an optimizer step, the checkpoint write, the eval/train handoff or
before the handler is installed shows only under random timing.  Cycles
rotate through the variants that reach distinct signal paths: plain
training, discriminator inter-training, boundary validation (the deferred
eval poll) and LoRA (the joint-state checkpoint)::

    python3 -m ucod_dpl_tpu_torch.tools.soak_preempt [--minutes 30] [--cycles N] [--seed 0]
        [--kill-after LO HI] [--kill-from launch|loop] [--keep] [--device cuda|cpu] [--root DIR] [--json OUT]

Per cycle: ``cli train -c <cfg> --work_dir <dir> --device <d>`` (run by
this module's ``--child`` mode, which calls
:func:`ucod_dpl_tpu_torch.cli.main` unchanged and writes the child's kernel
launch counts, ``ops.launches()``, when it exits) on a synthetic set,
SIGTERM after a delay drawn uniformly from ``--kill-after`` (default 2-45
s) by the seeded RNG, counted from the launch (``--kill-from launch``, the
JAX soak's clock) or from the train loop's "Starting training" line
(``loop``: the signal lands in the loop however long the child takes to
start), then (:func:`classify`):
  * completed  - the run ended before the signal (rc 0);
  * preempted  - rc 143 with ``state_preempt`` written: resume it
                 (``--resume``) and require rc 0 and the train loop's
                 "Resumed training state" line;
  * early-kill - rc 143 or death by the signal before the loop ran a batch,
                 no state (nothing trained, nothing lost);
  * anything else fails: the log's tail is printed and the soak exits 1.

It starts no cycle after ``--cycles`` cycles (no bound by default) or once
``--minutes`` have passed, and a child still running ``OVERRUN_S`` after
that is killed and fails the soak, so the soak's wall time is bounded.  On the CPU the backbone is the JAX soak's (hidden
64, 4 heads, 56px); on the card it is 256 wide (2 layers, 4 heads of 64),
so that K1 and K6 launch in the cache builds (the cycles share the caches,
as in the JAX soak: the first cycle builds them, and a later one rebuilds
what a kill left incomplete) and K2 and K3/K4 in the LoRA cycles; the
kernels are built in this process before the first cycle, so that no
child builds them under a signal.  The children's launch counts are summed
per variant in the result.  Exits 0 when no cycle failed.
"""

from __future__ import annotations

import argparse
import atexit
import glob
import json
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ucod_dpl_tpu_torch.tools.common import REPO, child_env, write_cod_set

RESUMED_LINE = "Resumed training state from"  # engine/train_loop.py::TrainLoop._resume
LOOP_LINE = "Starting training:"  # engine/train_loop.py::TrainLoop.run, just before it installs the handler
OVERRUN_S = 120.0  # how long a cycle may run on past --minutes before it is killed
START_FINETUNE = -5

_CFG = """
cfg = dict(
    mode="train",
    seed=42,
    model_cfg=dict(dim={hidden}, feature_size=8, dis_use_features=False,
                   ema_weight=0.99,
                   lora=dict(enable={lora}, rank=2, alpha=4.0, lr=1e-4)),
    train_cfg=dict(
        max_epoch={max_epoch}, start_finetune={start_finetune}, merge_method="dis", start_epoch=0,
        lr0=2e-4, dis_lr0=1e-3, dis_intertrain={dis_intertrain}, dis_epoch=1,
        step_lr_size=25, step_lr_gamma=0.95,
        save_cfg=dict(save_mode="all", save_interval=1000, start_save=0),
    ),
    val_cfg=dict(enable_val={enable_val}, val_interval=1, start_val=0,
                 look_twice=True, look_twice_th=0.95, expand_type="dynamic",
                 save_preds=False),
    log_cfg=dict(log_path={log_path!r}, multi_rank=[0], log_interval=1),
    tpu_cfg=dict(mesh=dict(data=-1, model=1)),
    dataset_cfg=dict(
        dataset_dir={dataset_dir!r},
        cache_dir={cache_dir!r},
        trainset_cfg=dict(DATASET="TINY", require_label=False,
                          image_size=(56, 56), bkg_th=0.6),
        valset_cfg=dict(DATASET="TINY", require_label=True,
                        image_size=(56, 56), keep_size=True),
        trainloader_cfg=dict(batch_size=2, shuffle=True),
        val_loader_cfg=dict(batch_size=1),
        feature_extractor_cfg=dict(
            type="dinov2", backbone="facebook/dinov2-base",
            backbone_weights="/nonexistent",
            arch=dict(hidden_size={hidden}, num_layers=2, num_heads=4,
                      patch_size=14, image_size=56),
        ),
    ),
)
"""

VARIANTS = (
    {"name": "plain", "dis_intertrain": 1000, "enable_val": False, "lora": False},
    {"name": "dis", "dis_intertrain": 1, "enable_val": False, "lora": False},
    {"name": "val", "dis_intertrain": 1000, "enable_val": True, "lora": False},
    {"name": "lora", "dis_intertrain": 1000, "enable_val": False, "lora": True},
)
OUTCOMES = ("completed", "preempted+resumed", "early-kill")


def classify(rc: Union[int, str], state_written: bool, log: str, resume_rc: Union[int, str, None] = None,
             resume_log: str = "") -> Tuple[str, str]:
    """A cycle's outcome from what its run left: ``rc`` (an exit code, a
    negative signal number for death by a signal, or "TIMEOUT"), whether
    ``state_preempt`` was written, the run's log, and for a preemption the
    resume's rc and log (None: not resumed yet).

    Returns (outcome, why): "completed", "preempted+resumed", "early-kill",
    "resume" (a graceful preemption with state whose resume has not run)
    or "failed"."""
    graceful = rc == 128 + signal.SIGTERM  # the handler saved and exited
    sig_death = rc == -signal.SIGTERM  # the default disposition: before the handler
    if rc == 0:
        return "completed", "the run ended before the signal"
    if graceful and state_written:
        if resume_rc is None:
            return "resume", "preempted with state: resume it"
        resumed = RESUMED_LINE in resume_log
        if resume_rc == 0 and resumed:
            return "preempted+resumed", "resumed to the end"
        return "failed", f"resume rc={resume_rc} resumed_log={resumed}"
    if (graceful or sig_death) and not state_written:
        # legal only before the loop ran a batch: after that a SIGTERM
        # without a checkpoint is a dropped preemption (every step logs its
        # loss at log_interval 1; an epoch logs "epoch N done")
        if re.search(r"epoch \d+ done|loss", log):
            return "failed", "the loop was running but no state was written"
        return "early-kill", "killed before the loop (nothing to save)"
    return "failed", f"unexpected outcome rc={rc} state={state_written}"


def write_cfg(path: str, base: Dict[str, str], variant: Dict, max_epoch: int, hidden: int) -> None:
    with open(path, "w") as f:
        f.write(_CFG.format(lora=variant["lora"], dis_intertrain=variant["dis_intertrain"],
                            enable_val=variant["enable_val"], max_epoch=max_epoch, start_finetune=START_FINETUNE,
                            hidden=hidden, **base))


def resume_epochs(saved_epoch: int) -> int:
    """The resumed run's ``max_epoch``: one epoch past the saved one, or two
    where one would make ``max_epoch + start_finetune`` zero (the merge
    ramp divides by it, and the step refuses it)."""
    return saved_epoch + 1 if saved_epoch + 1 + START_FINETUNE != 0 else saved_epoch + 2


def _child(counts: str, argv) -> int:
    """``--child COUNTS <cli argv>``: :func:`ucod_dpl_tpu_torch.cli.main` on
    ``argv``; the kernels' launch counts go to ``COUNTS`` (JSON) when the
    process exits, by a return or a ``SystemExit`` (a preemption's 128 +
    15)."""
    from ucod_dpl_tpu_torch import cli, ops

    ops.kernel_wrappers()  # imported now: a module imported at exit may not start its threads

    def write():
        with open(counts, "w") as f:
            json.dump(ops.launches(), f)

    atexit.register(write)
    return cli.main(argv)


def _log_has(log_file: str, offset: int, text: str) -> bool:
    with open(log_file) as f:
        f.seek(offset)
        return text in f.read()


def _run(cfg_path: str, work_dir: str, log_file: str, env: Dict[str, str], device: str, counts: str,
         until: float, resume: Optional[str] = None, kill_after: Optional[float] = None, kill_from: str = "launch"):
    """One ``cli train`` child; SIGTERM ``kill_after`` seconds after its
    launch or (``kill_from="loop"``) after its log shows the train loop
    started.  Killed at ``until`` (``time.monotonic``).  Returns (its exit
    code, negative: the signal that killed it, or "TIMEOUT"; seconds from
    the launch to the loop's start line when ``kill_from="loop"``, else
    None)."""
    cmd = [sys.executable, "-m", "ucod_dpl_tpu_torch.tools.soak_preempt", "--child", counts, "train", "-c", cfg_path,
           "--work_dir", work_dir, "--device", device]
    if resume:
        cmd += ["--resume", resume]
    with open(log_file, "a") as lf:
        lf.write(f"[soak] {time.strftime('%Y-%m-%d %H:%M:%S')} launch: {' '.join(cmd)}\n")
        lf.flush()
        offset = lf.tell()
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        try:
            t0 = loop_s = None
            launched = time.monotonic()
            if kill_after is not None:
                while t0 is None or time.monotonic() - t0 < kill_after:
                    if proc.poll() is not None:
                        return proc.returncode, loop_s
                    if time.monotonic() > until:
                        return "TIMEOUT", loop_s
                    if t0 is None and (kill_from == "launch" or _log_has(log_file, offset, LOOP_LINE)):
                        t0 = time.monotonic()
                        loop_s = t0 - launched if kill_from == "loop" else None
                    time.sleep(0.05)
                proc.send_signal(signal.SIGTERM)
            try:
                return proc.wait(timeout=max(until - time.monotonic(), 1.0)), loop_s
            except subprocess.TimeoutExpired:
                return "TIMEOUT", loop_s
        finally:
            if proc.poll() is None:  # never leave a child behind
                proc.kill()
                proc.wait()


def _tail(path: str, n: int = 2500) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "<no log>"


def _read_counts(paths) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for p in paths:
        if os.path.exists(p):
            with open(p) as f:
                for k, v in json.load(f).items():
                    total[k] = total.get(k, 0) + v
    return {k: v for k, v in total.items() if v}


def soak(minutes: float = 30.0, cycles: Optional[int] = None, seed: int = 0, kill_after=(2.0, 45.0),
         keep: bool = False, device: str = "cuda", root: Optional[str] = None, log=print,
         kill_from: str = "launch") -> Dict:
    """Run the soak; returns ``{"cycles": [...], "counts": {outcome: n},
    "launches": {variant: {kernel: n}}, "failed": bool, "root": dir}``.
    Each cycle's entry holds its label, outcome, delay, exit codes, saved
    epoch, seconds, launches and (``kill_from="loop"``) the seconds from its
    launch to the train loop's start."""
    if kill_from not in ("launch", "loop"):
        raise ValueError(f"kill_from must be 'launch' or 'loop'; got {kill_from!r}")
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("soak_preempt: device cuda requested but CUDA is not available; pass --device cpu")
        from ucod_dpl_tpu_torch.ops import _build

        _build.kernels()  # built here once: a child killed mid-build must not be the one that builds them
    rng = random.Random(seed)
    root = root or tempfile.mkdtemp(prefix="ucod_soak_")
    os.makedirs(root, exist_ok=True)
    log(f"soak root: {root}")
    from ucod_dpl_tpu_torch.utils.fileio import ArrayCache

    write_cod_set(os.path.join(root, "RefCOD", "TINY"), 4, "disc")
    prng = np.random.default_rng(0)
    ArrayCache(os.path.join(root, "cache", "pseudo_label_cache", "TINY")).dump_list(
        [(prng.random((4, 4, 1)) > 0.5).astype(np.float32) for _ in range(4)])
    env = child_env()
    hidden = 256 if device.startswith("cuda") else 64  # K6 takes hidden % 256 == 0
    deadline = time.monotonic() + minutes * 60
    until = deadline + OVERRUN_S
    counts = {k: 0 for k in OUTCOMES}
    launches: Dict[str, Dict[str, int]] = {}
    results = []
    failed = False
    cycle = 0
    while time.monotonic() < deadline and (cycles is None or cycle < cycles) and not failed:
        t0 = time.perf_counter()
        variant = VARIANTS[cycle % len(VARIANTS)]
        cyc_dir = os.path.join(root, f"cycle{cycle:03d}")
        os.makedirs(cyc_dir)
        base = {"log_path": os.path.join(cyc_dir, "logs"), "dataset_dir": os.path.join(root, "RefCOD"),
                "cache_dir": os.path.join(root, "cache")}
        cfg_path, log_file = os.path.join(cyc_dir, "cfg.py"), os.path.join(cyc_dir, "run.out")
        count_files = [os.path.join(cyc_dir, "launches_run.json"), os.path.join(cyc_dir, "launches_resume.json")]
        write_cfg(cfg_path, base, variant, 10_000_000, hidden)
        delay = rng.uniform(*kill_after)
        rc, loop_s = _run(cfg_path, os.path.join(cyc_dir, "work"), log_file, env, device, count_files[0], until,
                          kill_after=delay, kill_from=kill_from)
        states = glob.glob(os.path.join(cyc_dir, "**", "state_preempt.npz"), recursive=True)
        at = f"loop+{delay:.1f}s" if kill_from == "loop" else f"{delay:.1f}s"
        label = f"cycle {cycle:03d} [{variant['name']}] kill@{at} rc={rc}"
        outcome, why = classify(rc, bool(states), _tail(log_file, 25_000))
        entry = {"cycle": cycle, "variant": variant["name"], "kill_after": delay, "kill_from": kill_from, "rc": rc,
                 "loop_s": loop_s}
        if outcome == "resume":
            with open(states[0][: -len(".npz")] + ".json") as f:
                saved_epoch = int(json.load(f)["epoch"])
            write_cfg(cfg_path, base, variant, resume_epochs(saved_epoch), hidden)
            with open(log_file) as f:
                seen = len(f.read())
            rc2, _ = _run(cfg_path, os.path.join(cyc_dir, "work"), log_file, env, device, count_files[1], until,
                          resume=states[0][: -len(".npz")])
            with open(log_file) as f:
                resume_log = f.read()[seen:]
            outcome, why = classify(rc, True, "", rc2, resume_log)
            entry.update(resume_rc=rc2, saved_epoch=saved_epoch)
            if outcome == "preempted+resumed":
                why = f"preempted at epoch {saved_epoch}, resumed OK"
        entry.update(outcome=outcome, label=label, seconds=time.perf_counter() - t0,
                     launches=_read_counts(count_files))
        for k, v in entry["launches"].items():
            launches.setdefault(variant["name"], {})
            launches[variant["name"]][k] = launches[variant["name"]].get(k, 0) + v
        results.append(entry)
        if outcome == "failed":
            failed = True
            log(f"FAIL {label}: {why}\n{_tail(log_file)}")
        else:
            counts[outcome] += 1
            log(f"{label} -> {why}")
            if not keep:
                shutil.rmtree(cyc_dir, ignore_errors=True)
        cycle += 1
    log(f"soak: {cycle} cycles -> {counts}" + ("  [FAILED]" if failed else "  [OK]"))
    if not keep and not failed:
        shutil.rmtree(root, ignore_errors=True)
    return {"cycles": results, "counts": counts, "launches": launches, "failed": failed, "root": root}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:  # one cycle's child: --child COUNTS <cli argv>
        return _child(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--cycles", type=int, default=None, help="stop after this many cycles (default: no bound)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-after", type=float, nargs=2, default=(2.0, 45.0), metavar=("LO", "HI"),
                    help="the SIGTERM's delay is drawn uniformly from [LO, HI] seconds (default 2 45)")
    ap.add_argument("--kill-from", choices=("launch", "loop"), default="launch",
                    help="count the delay from the child's launch (default) or from its train loop's start")
    ap.add_argument("--keep", action="store_true", help="keep the work dir")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--root", default=None, help="work directory (default: a new temporary one)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    res = soak(args.minutes, args.cycles, args.seed, tuple(args.kill_after), args.keep, args.device, args.root,
               kill_from=args.kill_from)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
