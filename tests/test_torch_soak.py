"""The port's randomized preemption soak (``ucod_dpl_tpu_torch.tools.soak_preempt``).

* :func:`classify` on every outcome the JAX script tells apart: completed;
  preempted and resumed; killed before the loop; and the failures (rc 143
  with the loop running and no state, a resume that does not print the
  train loop's "Resumed training state" line or does not exit 0, a
  timeout, death by another signal).
* A soak of 4 cycles on the CPU, one per variant (plain, discriminator
  inter-training, boundary validation, LoRA), a fixed seed and SIGTERM 3-8 s
  after each launch, under its own 2-minute bound: exit 0.
* The child mode writes its launch counts however it exits, and the lines
  the soak reads are the train loop's.
* One cycle with the delay counted from the train loop's start: preempted
  and resumed.
"""

import json
import signal

import pytest

from ucod_dpl_tpu_torch.tools import soak_preempt as S

RUNNING = "2026 | INFO | ucod | epoch 0 iter 1: loss=0.6931 dis=0.0000 w=0.00\n"
STARTING = "2026 | INFO | ucod | Building the feature cache of TINY\n"
RESUMED = "2026 | INFO | ucod | Resumed training state from /w/ckp/state_preempt (epoch 3, ...)\n"
TERM = 128 + signal.SIGTERM

CASES = [
    # (id, run rc, state written, run log, resume rc, resume log, outcome)
    ("completed", 0, False, RUNNING, None, "", "completed"),
    ("preempted, resume pending", TERM, True, RUNNING, None, "", "resume"),
    ("preempted and resumed", TERM, True, RUNNING, 0, RESUMED, "preempted+resumed"),
    ("early kill, default disposition", -signal.SIGTERM, False, STARTING, None, "", "early-kill"),
    ("early kill, handler without state", TERM, False, STARTING, None, "", "early-kill"),
    ("loop running, no state", TERM, False, RUNNING, None, "", "failed"),
    ("killed by the signal mid-loop", -signal.SIGTERM, False, RUNNING + "epoch 0 done: 2 iters", None, "", "failed"),
    ("resume without the resumed line", TERM, True, RUNNING, 0, "epoch 4 done: 2 iters\n", "failed"),
    ("resume that fails", TERM, True, RUNNING, 1, RESUMED, "failed"),
    ("timeout", "TIMEOUT", False, RUNNING, None, "", "failed"),
    ("resume timeout", TERM, True, RUNNING, "TIMEOUT", RESUMED, "failed"),
    ("killed by another signal", -signal.SIGKILL, False, STARTING, None, "", "failed"),
    ("a crash", 1, False, RUNNING, None, "", "failed"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_classify(case):
    _, rc, state, log, resume_rc, resume_log, want = case
    outcome, why = S.classify(rc, state, log, resume_rc, resume_log)
    assert outcome == want, why


def test_resumed_line_is_the_train_loops():
    import inspect

    from ucod_dpl_tpu_torch.engine.train_loop import TrainLoop

    assert S.RESUMED_LINE in inspect.getsource(TrainLoop._resume)


def test_loop_line_is_the_train_loops():
    import inspect

    from ucod_dpl_tpu_torch.engine.train_loop import TrainLoop

    src = inspect.getsource(TrainLoop.run)
    assert f'"{S.LOOP_LINE}' in src.replace("f\"", "\"") and src.index(S.LOOP_LINE) < src.index("preempt.install()")


@pytest.mark.parametrize("argv, rc", [(["compute_metrics", "--gt-dir", "/nonexistent", "--pred-dir", "/x"], 1),
                                      (["no_such_command"], 2)], ids=["raises", "returns"])
def test_child_writes_launch_counts_at_exit(tmp_path, argv, rc):
    """``--child COUNTS``: the cli's own exit, and a child that dies by an
    exception, still leave the launch counts (every kernel, 0 on the CPU)."""
    import subprocess
    import sys

    from ucod_dpl_tpu_torch import ops
    from ucod_dpl_tpu_torch.tools.common import REPO, child_env

    counts = tmp_path / "counts.json"
    proc = subprocess.run([sys.executable, "-m", "ucod_dpl_tpu_torch.tools.soak_preempt", "--child", str(counts),
                           *argv], cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr[-2000:]
    assert json.loads(counts.read_text()) == {k: 0 for k in ops.kernel_wrappers()}


def test_resume_epochs_never_zero_the_merge_ramp():
    for saved in range(10):
        max_epoch = S.resume_epochs(saved)
        assert max_epoch > saved and max_epoch + S.START_FINETUNE != 0


def test_soak_four_cycles_on_the_cpu(tmp_path):
    out = tmp_path / "soak.json"
    rc = S.main(["--device", "cpu", "--cycles", "4", "--minutes", "2", "--seed", "0", "--kill-after", "3", "8",
                 "--json", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and not res["failed"], res["cycles"]
    assert [c["variant"] for c in res["cycles"]] == ["plain", "dis", "val", "lora"]
    assert sum(res["counts"].values()) == 4
    for c in res["cycles"]:
        assert c["outcome"] in S.OUTCOMES and c["label"].startswith(f"cycle {c['cycle']:03d} [{c['variant']}] kill@")


def test_soak_kill_from_the_loop_on_the_cpu(tmp_path):
    """``--kill-from loop``: the delay counts from the train loop's start
    line, so a SIGTERM 0.5-2 s after it always preempts a running loop."""
    out = tmp_path / "soak.json"
    rc = S.main(["--device", "cpu", "--cycles", "1", "--minutes", "2", "--seed", "0", "--kill-from", "loop",
                 "--kill-after", "0.5", "2", "--json", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and res["counts"]["preempted+resumed"] == 1, res["cycles"]
    (c,) = res["cycles"]
    assert c["kill_from"] == "loop" and c["loop_s"] > 0 and c["label"].startswith("cycle 000 [plain] kill@loop+")
