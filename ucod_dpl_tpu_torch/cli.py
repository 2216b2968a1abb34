"""Command-line entry points of the port, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.cli` (the reference's ``scripts/*.py``)::

    python3 -m ucod_dpl_tpu_torch.cli train -c configs/uscod/UCOD-DPL_dinov2.py \\
        [--resume STATE] [--load_from CKPT] [--profile] [--device cuda|cpu] [--opts key value ...]
    python3 -m ucod_dpl_tpu_torch.cli eval -c configs/uscod/UCOD-DPL_dinov2.py \\
        [--load_from CKPT] [--datasets A,B] [--device cuda|cpu] [--opts key value ...]

The flags are the JAX package's, plus ``--device`` (default ``cuda``: the
card; ``cpu`` runs the plain versions of the kernels).  Stage-1 training
(``train``; ``--resume`` takes a ``state_epochN`` or ``state_preempt`` of
either package) and evaluation (``eval``) are ported; ``lt_train`` and
``lt_eval`` (ROADMAP Queue 1 item 15) and ``generate_pseudo_label`` (item
14) raise ``NotImplementedError``.  The engine is imported inside the entry
bodies, so ``--help`` and argument errors cost nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

__all__ = [
    "parse_args",
    "init_cfg",
    "train_main",
    "eval_main",
    "lt_train_main",
    "lt_eval_main",
    "generate_pseudo_label_main",
    "main",
]

_EVAL_DEFAULT_DATASETS = ["CHAMELEON", "TE-CAMO", "TE-COD10K", "NC4K"]


def parse_args(description: str = "ucod-dpl-tpu-torch", argv=None):
    """The JAX package's flags (the reference's ``scripts/args.py``) and
    ``--device``."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", "-c", help="config file path", required=True)
    parser.add_argument("--work_dir", type=str, default="work_dir", help="work dir")
    parser.add_argument("--resume", type=str, default=None, help="resume from checkpoint")
    parser.add_argument("--load_from", type=str, default=None, help="load from checkpoint")
    parser.add_argument("--refiner_path", type=str, default=None, help="load refiner checkpoint")
    parser.add_argument(
        "--datasets", type=str, default=None, help="comma-separated eval dataset names (overrides the default list)"
    )
    parser.add_argument(
        "--profile", action="store_true", help="record a torch.profiler trace under <work_dir>/profile"
    )
    parser.add_argument(
        "--device", type=str, default="cuda", help="torch device of the run (default cuda; cpu runs the plain path)"
    )
    parser.add_argument(
        "--opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides: key value [key value ...]"
    )
    return parser.parse_args(argv)


def init_cfg(args, mode: str):
    """Load the config with ``--opts``, set the mode, and derive ``work_dir``
    from the config's path as the reference does (``scripts/train.py:14-18``);
    logs go under it unless ``--opts log_cfg.log_path`` says otherwise."""
    from ucod_dpl_tpu_torch.config import load_config

    cfg = load_config(args.config, overrides=args.opts or None)
    cfg.mode = mode
    cfg.dataset_cfg.valset_cfg.keep_size = mode != "train"
    if args.resume:
        cfg.train_cfg.resume = args.resume
    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    try:
        rel = os.path.relpath(cfg_dir, os.path.abspath("./configs"))
    except ValueError:
        rel = os.path.basename(cfg_dir)
    if rel.startswith(".."):
        rel = os.path.basename(cfg_dir)
    cfg.work_dir = os.path.join(args.work_dir, rel, os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(cfg.work_dir, exist_ok=True)
    if "log_cfg.log_path" not in (args.opts or []):
        cfg.log_cfg.log_path = os.path.join(cfg.work_dir, "logs")
    return cfg


def train_main(argv=None):
    """Stage-1 UCOD-DPL training (the reference's ``scripts/train.py``).
    Returns the Runner (``runner.train_loop`` holds the loop's state)."""
    args = parse_args("UCOD-DPL stage-1 training", argv)
    cfg = init_cfg(args, mode="train")

    from ucod_dpl_tpu_torch.engine.runner import Runner
    from ucod_dpl_tpu_torch.utils.profiling import maybe_profile
    from ucod_dpl_tpu_torch.utils.seed import set_random_seed

    set_random_seed(42)
    runner = Runner(cfg, mode="train", load_from=args.load_from, device=args.device)
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        runner.launch_train()
    return runner


def eval_main(argv=None) -> Dict[str, object]:
    """Stage-1 LookTwice evaluation of each dataset (the reference's
    ``scripts/eval.py``) with one feature extractor shared by all of them.
    Prints one result line per dataset, as the JAX package does, and returns
    each dataset's Runner (``runner.evaluator`` holds its counters)."""
    args = parse_args("UCOD-DPL stage-1 eval (LookTwice)", argv)
    cfg = init_cfg(args, mode="eval")
    datasets = args.datasets.split(",") if args.datasets else _EVAL_DEFAULT_DATASETS

    from ucod_dpl_tpu_torch.engine.runner import Runner
    from ucod_dpl_tpu_torch.utils.profiling import maybe_profile
    from ucod_dpl_tpu_torch.utils.seed import set_random_seed

    set_random_seed(42)
    results, runners = {}, {}
    fe = None  # built by the first Runner, shared by the rest
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        for dataset in datasets:
            cfg.dataset_cfg.valset_cfg.DATASET = dataset
            print(f"running {dataset}")
            runner = Runner(cfg, mode="eval", load_from=args.load_from, feature_extractor=fe, device=args.device)
            fe = runner.feature_extractor
            results[dataset] = runner.launch_val_look_twice()
            runners[dataset] = runner
    for name, res in results.items():
        print(name, {k: round(v, 4) for k, v in res.items()})
    return runners


def lt_train_main(argv=None):
    raise NotImplementedError("CORAL stage-2 training is ROADMAP Queue 1 item 15")


def lt_eval_main(argv=None):
    raise NotImplementedError("CORAL stage-2 evaluation is ROADMAP Queue 1 item 15")


def generate_pseudo_label_main(argv=None):
    raise NotImplementedError("pseudo-label generation is ROADMAP Queue 1 item 14")


_COMMANDS = {
    "train": train_main,
    "eval": eval_main,
    "lt_train": lt_train_main,
    "lt_eval": lt_eval_main,
    "generate_pseudo_label": generate_pseudo_label_main,
}


def main(argv=None) -> int:
    """``python3 -m ucod_dpl_tpu_torch.cli <command> [flags]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in _COMMANDS:
        print(f"usage: python3 -m ucod_dpl_tpu_torch.cli {{{','.join(_COMMANDS)}}} [flags]", file=sys.stderr)
        return 2
    _COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
