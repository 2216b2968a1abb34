"""The port's process groups (``ucod_dpl_tpu_torch.parallel.distributed``)
and cluster-agreed preemption (``engine/preempt.py``) over gloo on the CPU.

Ranks are subprocesses started as a launcher starts them (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on a free
localhost port, ``device="cpu"``); each asserts what it sees and prints a
line the test reads.  As tests/test_distributed_4proc.py holds the JAX
package: the ragged metric gather over 4 ranks with counts (3, 0, 2, 1)
gives every rank the rank-ordered concatenation (exactly: float64
payloads).  As tests/test_distributed_preempt.py: one rank's SIGTERM flag
is seen by both ranks at the same ``requested_global`` call, and
``GlobalPoll`` with local counts (5, 2) and ``every=2`` runs the same
rounds on both ranks and raises at the same round.  ``UCOD_DIST=1`` starts
a group of one, which launches no collective.  ``run_ranks`` is the launcher of
tests/test_torch_distributed_train.py and test_torch_distributed_eval.py.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from ucod_dpl_tpu_torch.parallel import distributed as D

pytestmark = pytest.mark.heavy  # multi-process: excluded from the quick loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, name, script, world, args=(), env=None, timeout=180, check=True):
    """Run ``script`` (Python source) as ``world`` ranks of one gloo group;
    ``world=0`` runs it once as a plain process (no group).  Returns each
    rank's (exit code, output); with ``check``, every rank must exit 0."""
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(script))
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "UCOD_DIST")}
    base.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", **(env or {}))
    port = str(_free_port())
    procs = []
    for rank in range(max(world, 1)):
        e = dict(base)
        if world:
            e.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, str(path), *map(str, args)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, env=e, cwd=REPO))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # never leave a rank behind
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [(p.returncode, out) for p, out in zip(procs, outs)]
    if check:
        for rank, (rc, out) in enumerate(res):
            assert rc == 0, f"rank {rank} exit {rc}:\n{out[-4000:]}"
    return res


def result_lines(out: str, tag: str = "RESULT"):
    """The JSON objects a rank printed after ``tag``."""
    return [json.loads(line[len(tag) + 1:]) for line in out.splitlines() if line.startswith(tag + " ")]


_GATHER = '''
import json, os
import numpy as np
from ucod_dpl_tpu_torch.parallel import distributed as D

assert D.maybe_initialize_distributed("cpu").type == "cpu"
rank, world = D.process_index(), D.process_count()
assert world == 4 and D.process_shard() == (rank, 4) and D.is_main_process() == (rank == 0)
counts = [3, 0, 2, 1]
local = [np.full((2, 3), 10.0 * rank + i) + 0.125 for i in range(counts[rank])]
got = D.gather_ragged(local)
want = [np.full((2, 3), 10.0 * q + i) + 0.125 for q in range(4) for i in range(counts[q])]
assert len(got) == len(want) == 6, len(got)
for a, b in zip(got, want):
    assert a.dtype == np.float64 and np.array_equal(a, b), (a, b)
# scalar items (the per-image metrics) and a gather where no rank has any
scalars = D.gather_object_lists([float(rank)] * counts[rank])
assert [float(x) for x in scalars] == [0.0, 0.0, 0.0, 2.0, 2.0, 3.0], scalars
assert D.gather_ragged([]) == []
# the device collectives over the default group: the gradient average, one
# bucket per dtype; the batch-norm sum, whose backward sums the ranks'
# incoming gradients; the logged-loss mean
import torch
grads = [torch.arange(3.0) + rank, torch.full((2, 2), 4.0 * rank), torch.arange(2, dtype=torch.float64) * rank]
D.all_reduce_mean_(grads)
want = [torch.arange(3.0) + 1.5, torch.full((2, 2), 6.0), torch.arange(2, dtype=torch.float64) * 1.5]
assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(grads, want)), grads
assert D.grad_all_reduce == {"calls": 2, "bytes": 7 * 4 + 2 * 8}, D.grad_all_reduce
x = (torch.arange(4.0) + rank).requires_grad_(True)
y = D.all_reduce_sum(x)
assert torch.equal(y, 4 * torch.arange(4.0) + 6)
(y * torch.arange(4.0) * (rank + 1)).sum().backward()
assert torch.equal(x.grad, 10 * torch.arange(4.0)), x.grad
m = D.all_reduce_mean(torch.tensor(2.0 * rank, requires_grad=True))
assert float(m) == 3.0 and not m.requires_grad
D.barrier("end")
print("RESULT " + json.dumps({"rank": rank, "n": len(got)}))
'''


def test_gather_ragged_over_4_ranks(tmp_path):
    """Counts (3, 0, 2, 1): every rank gets the same 6 items in rank order,
    bit for bit, a rank with none included.  The device collectives over
    the same 4 ranks, exactly: the gradient average in one bucket per
    dtype, the differentiable sum (its backward sums the ranks' gradients)
    and the logged-loss mean."""
    res = run_ranks(tmp_path, "gather", _GATHER, 4)
    assert [result_lines(out)[0] for _, out in res] == [{"rank": r, "n": 6} for r in range(4)]


_PREEMPT = '''
import json, os, signal
from ucod_dpl_tpu_torch.engine import preempt
from ucod_dpl_tpu_torch.parallel import distributed as D

D.maybe_initialize_distributed("cpu")
rank = D.process_index()
preempt.install()
seen = []
for call in range(5):
    if rank == 1 and call == 2:
        os.kill(os.getpid(), signal.SIGTERM)  # this rank's own flag only
        assert preempt.requested() == signal.SIGTERM
    seen.append(preempt.requested_global())
local_before = preempt.requested()
preempt.clear()

# GlobalPoll over local counts (5, 2), every 2: ceil(5 / 2) = 3 rounds on both
counts = (5, 2)
poll = preempt.GlobalPoll(counts[rank], every=2)
for _ in range(counts[rank]):
    poll.step()
poll.finish()
clean = (poll.rounds_total, poll.rounds_done)
# the same with rank 0 flagged after its 3rd batch: its round 2 comes at its
# 4th batch, rank 1's in finish(); both raise there
poll = preempt.GlobalPoll(counts[rank], every=2)
raised = None
try:
    for i in range(counts[rank]):
        if rank == 0 and i == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        poll.step()
    poll.finish()
except preempt.Preempted as e:
    raised = (poll.rounds_done, e.signum)
print("RESULT " + json.dumps({"seen": seen, "local": local_before, "clean": clean, "raised": raised}))
'''


def test_preemption_flag_agreed_over_2_ranks(tmp_path):
    """SIGTERM to rank 1 alone before its 3rd ``requested_global`` call:
    both ranks get None, None, then SIGTERM from the 3rd call on, though
    rank 0's own flag stays clear.  ``GlobalPoll(5 | 2, every=2)``: 3 rounds
    on each rank, and with rank 0 flagged after its 3rd batch both raise at
    round 2."""
    res = run_ranks(tmp_path, "preempt", _PREEMPT, 2)
    r0, r1 = (result_lines(out)[0] for _, out in res)
    term = int(signal.SIGTERM)
    assert r0["seen"] == r1["seen"] == [None, None, term, term, term]
    assert (r0["local"], r1["local"]) == (None, term)
    assert r0["clean"] == r1["clean"] == [3, 3]
    assert r0["raised"] == r1["raised"] == [2, term]


_GROUP_OF_ONE = '''
import json, os
import numpy as np
import torch
import torch.distributed as dist
from ucod_dpl_tpu_torch.engine import preempt
from ucod_dpl_tpu_torch.parallel import distributed as D

assert not dist.is_initialized()
assert D.maybe_initialize_distributed("cpu") == torch.device("cpu")
D.maybe_initialize_distributed("cpu")  # idempotent
assert dist.is_initialized() and D.process_count() == 1 and D.process_index() == 0
assert dist.get_backend() == "gloo"
items = [np.ones(3)]
assert D.gather_ragged(items) is items  # a world of one: no host collective
assert preempt.requested_global() is None and preempt.GlobalPoll(4).single
# nor a device collective: a group of one is a plain run
grads = [torch.arange(3.0), torch.ones(2, 2), torch.arange(2, dtype=torch.float64)]
before = [g.clone() for g in grads]
D.all_reduce_mean_(grads)
assert all(torch.equal(a, b) for a, b in zip(grads, before))
assert D.grad_all_reduce == {"calls": 0, "bytes": 0}, D.grad_all_reduce
x = torch.arange(4.0, requires_grad=True)
assert D.all_reduce_sum(x) is x
print("RESULT " + json.dumps({"world": D.process_count()}))
'''


def test_ucod_dist_starts_a_group_of_one(tmp_path):
    """``UCOD_DIST=1`` without a launcher: a gloo group of one (an
    in-process rendezvous) that launches no collective, host or device."""
    res = run_ranks(tmp_path, "one", _GROUP_OF_ONE, 0, env={"UCOD_DIST": "1"})
    assert result_lines(res[0][1]) == [{"world": 1}]


def test_no_fallback_without_a_card(monkeypatch):
    """A CUDA rank raises when there is no card and when ``LOCAL_RANK`` is
    past the visible cards, before any group starts; without a launcher's
    variables nothing starts and the device is the one asked for."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("UCOD_DIST", raising=False)
    assert D.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized() and D.process_count() == 1
    monkeypatch.setenv("UCOD_DIST", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.maybe_initialize_distributed("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1"):
        D.maybe_initialize_distributed("cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="maybe_initialize_distributed"):
        D.all_gather_host([0])  # host collectives need a group


def test_coral_training_refuses_more_than_one_process_before_any_build(tmp_path, monkeypatch):
    """``LocalRefineRunner(mode="train")`` under a launcher's ``WORLD_SIZE=2``
    refuses first: no group starts, no directory or cache is made (the
    configuration is empty, so any later step would fail otherwise)."""
    from ucod_dpl_tpu_torch.config import CfgNode
    from ucod_dpl_tpu_torch.engine.runner import LocalRefineRunner

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="single-process"):
        LocalRefineRunner(CfgNode({"work_dir": str(tmp_path / "wd")}), mode="train", device="cpu")
    assert not torch.distributed.is_initialized() and not any(tmp_path.iterdir())
