"""Request latency of ``Predictor(quantize="int8")`` on the card, this tree
against a parent.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 -m ucod_dpl_tpu_torch.tools.serve_ab [--parent DIR] [--reps 5]

A full-width dinov2-base ``Predictor`` at 518px with the int8 linears
(seeded random weights, ``max_batch`` 16) answers requests of 1, 5 and 16
images (buckets 1, 8 and 16): one warm-up request of each size, then
``--reps`` rounds over the sizes, each request timed on the host clock from
``predict`` to its masks, what a caller waits for.  Prints each size's
median and least time.

* ``--parent DIR``: the same measurement of DIR's package (a checkout
  unpacked with ``git archive``; its kernels built by its own
  ``ops/_build.py``) and of this tree's, each run in a process of its own
  (this file run with ``PYTHONPATH`` set to the tree), in the order this,
  parent, parent, this, after one untimed process (the first on a machine
  ran its requests up to 40% slower); each size's median over the two runs
  of a tree.
  The measurement uses only what both trees have: ``FeatureExtractor``,
  ``init_rev_decoder`` and ``Predictor``.

Exits 1 without a CUDA device.  The last line of the output is a JSON
object of the times in seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SIZES = (1, 5, 16)
REPO = Path(__file__).resolve().parents[2]


class _Cfg(dict):
    """The attribute-style config node the feature extractor reads."""

    __getattr__ = dict.__getitem__


def measure(reps: int, seed: int = 0) -> dict:
    """Request size -> its ``reps`` host-clock times in seconds, in order."""
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.models.dba import init_rev_decoder
    from ucod_dpl_tpu_torch.serving import Predictor

    cfg = _Cfg(type="dinov2", backbone="facebook/dinov2-base", backbone_weights=None)
    fe = FeatureExtractor(cfg, device=torch.device("cuda", 0), seed=seed, strict=False, quantize="int8")
    predictor = Predictor(fe, init_rev_decoder(seed + 1, fe.config.hidden_size), image_size=(518, 518),
                          feature_size=68, max_batch=16)
    rng = np.random.default_rng(seed + 2)
    images = {n: list(rng.standard_normal((n, 518, 518, 3)).astype(np.float32)) for n in SIZES}
    for n in SIZES:
        predictor.predict(images[n])
    times = {n: [] for n in SIZES}
    for _ in range(reps):
        for n in SIZES:
            t0 = time.perf_counter()
            predictor.predict(images[n])
            times[n].append(time.perf_counter() - t0)
    return times


def _run(tree: Path, reps: int) -> dict:
    """:func:`measure` of ``tree``'s package, in a process of its own."""
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", "--reps", str(reps)], cwd=tree,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"serve_ab in {tree} failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return {int(n): v for n, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}


def _summary(times) -> str:
    return ", ".join(f"request of {n}: median {statistics.median(v) * 1e3:.2f} ms, least {min(v) * 1e3:.2f}"
                     for n, v in times.items())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="checkout of the parent tree to time against")
    parser.add_argument("--reps", type=int, default=5, help="timed rounds over the request sizes")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_ab: CUDA is not available", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(measure(args.reps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.parent is None:
        results = {"this": measure(args.reps)}
        print(f"int8 Predictor, this tree: {_summary(results['this'])}", flush=True)
    else:
        _run(REPO, 1)  # untimed: the first process of a machine runs slower
        runs = [(name, _run(tree, args.reps)) for name, tree in
                (("this", REPO), ("parent", args.parent.resolve()), ("parent", args.parent.resolve()),
                 ("this", REPO))]
        results = {name: {n: [t for run_name, run in runs if run_name == name for t in run[n]] for n in SIZES}
                   for name in ("this", "parent")}
        for name in ("parent", "this"):
            print(f"int8 Predictor, {name} ({2 * args.reps} requests a size over two processes): "
                  f"{_summary(results[name])}", flush=True)
    print(json.dumps({"card": smi, **{name: {str(n): v for n, v in t.items()} for name, t in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
