"""Command-line entry points of the port, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.cli` (the reference's ``scripts/*.py``)::

    python3 -m ucod_dpl_tpu_torch.cli train -c configs/uscod/UCOD-DPL_dinov2.py \\
        [--resume STATE] [--load_from CKPT] [--profile] [--device cuda|cpu] [--opts key value ...]
    python3 -m ucod_dpl_tpu_torch.cli eval -c configs/uscod/UCOD-DPL_dinov2.py \\
        [--load_from CKPT] [--datasets A,B] [--device cuda|cpu] [--opts key value ...]
    python3 -m ucod_dpl_tpu_torch.cli lt_eval -c configs/uscod/CORAL_dinov2.py \\
        [--load_from CKPT] [--refiner_path CKPT] [--datasets A,B] [--device cuda|cpu] [--opts ...]
    python3 -m ucod_dpl_tpu_torch.cli generate_pseudo_label [--dataset A+B] [--image_path TEMPLATE] \\
        [--cache_path DIR] [--backbone_weights DIR] [--th_bkg 0.6] [--batch_size 16] \\
        [--image_size 224] [--fe_type dinov2|dinov1] [--overwrite] [--device cuda|cpu]

The flags are the JAX package's, plus ``--device`` (default ``cuda``: the
card; ``cpu`` runs the plain versions of the kernels).  Stage-1 training
(``train``; ``--resume`` takes a ``state_epochN`` or ``state_preempt`` of
either package), stage-1 evaluation (``eval``), CORAL stage-2 evaluation
(``lt_eval``) and pseudo-label generation are ported; ``lt_train`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 15's training half).  The
engine is imported inside the entry bodies, so ``--help`` and argument
errors cost nothing.
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
    raise NotImplementedError("CORAL stage-2 training is ROADMAP Queue 1 item 15's training half")


def lt_eval_main(argv=None) -> Dict[str, object]:
    """CORAL stage-2 evaluation of each dataset (the reference's
    ``scripts/LTeval.py``): the stage-1 decoder from ``--load_from``, the
    refiner from ``--refiner_path`` (else a seeded init), one feature
    extractor shared by all datasets.  Prints one result line per dataset,
    as the JAX package does, and returns each dataset's
    ``LocalRefineRunner`` (``runner.evaluator`` holds its counters)."""
    args = parse_args("CORAL stage-2 eval (UDLR)", argv)
    cfg = init_cfg(args, mode="eval")
    datasets = args.datasets.split(",") if args.datasets else _EVAL_DEFAULT_DATASETS

    from ucod_dpl_tpu_torch.engine.runner import LocalRefineRunner
    from ucod_dpl_tpu_torch.utils.profiling import maybe_profile
    from ucod_dpl_tpu_torch.utils.seed import set_random_seed

    set_random_seed(42)
    results, runners = {}, {}
    fe = None  # built by the first Runner, shared by the rest
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        for dataset in datasets:
            cfg.dataset_cfg.valset_cfg.DATASET = dataset
            print(f"running {dataset}")
            runner = LocalRefineRunner(cfg, mode="eval", load_from=args.load_from, refiner_path=args.refiner_path,
                                       feature_extractor=fe, device=args.device)
            fe = runner.feature_extractor
            results[dataset] = runner.launch_val()
            runners[dataset] = runner
    for name, res in results.items():
        print(name, {k: round(v, 4) for k, v in res.items()})
    return runners


def generate_pseudo_label_main(argv=None) -> str:
    """Pseudo-label generation (the reference's ``generate_pseudo_label.py``),
    the JAX package's flags plus ``--device``.

    DINOv2-base (or DINO ViT-B/8) at ``--image_size`` over the training
    images, in batches of ``--batch_size``: the last layer's CLS attention
    and key tokens (``FeatureExtractor.extract_with_attention``; on the card
    K1 and K6 launch 11 times per batch), the background mask on the device
    (``ops.pseudo_label.compute_background_mask``), the host's small-component
    cleanup, and each foreground mask written as a (grid, grid, 1) float32
    entry of the JAX package's pseudo-label cache with its meta ``n``,
    ``fingerprint`` and ``th_bkg``.  A complete cache is left as it is unless
    ``--overwrite``.  Returns the cache's directory."""
    parser = argparse.ArgumentParser(description="Generate pseudo labels for COD datasets")
    parser.add_argument("--dataset", type=str, default="TR-CAMO+TR-COD10K", help="Dataset name(s), '+'-joined")
    parser.add_argument("--image_path", type=str, default="./datasets/RefCOD/{}/im",
                        help="Template path for images ({} = dataset name)")
    parser.add_argument("--cache_path", type=str, default="./datasets/cache/pseudo_label_cache/",
                        help="Cache output root")
    parser.add_argument("--backbone_weights", type=str, default="./weights",
                        help="Local HuggingFace weight dir for facebook/dinov2-base")
    parser.add_argument("--th_bkg", type=float, default=0.6)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--fe_type", type=str, default="dinov2", choices=["dinov1", "dinov2"])
    parser.add_argument("--overwrite", action="store_true",
                        help="Regenerate even if a complete cache exists (e.g. after changing --th_bkg)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the run (default cuda; cpu runs the plain path)")
    args = parser.parse_args(argv)

    import hashlib

    import numpy as np
    import torch

    from ucod_dpl_tpu_torch.config import CfgNode
    from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu_torch.data.transforms import load_image_batch_transform
    from ucod_dpl_tpu_torch.ops.pseudo_label import compute_background_mask, refine_small_components
    from ucod_dpl_tpu_torch.utils.fileio import ArrayCache, ImageIO
    from ucod_dpl_tpu_torch.utils.logger import get_logger

    logger = get_logger()
    fe = FeatureExtractor(
        CfgNode({
            "type": args.fe_type,
            "backbone": "facebook/dinov2-base" if args.fe_type == "dinov2" else "facebook/dino-vitb8",
            "backbone_weights": args.backbone_weights,
        }),
        device=args.device,
    )
    image_paths = []
    for dataset in args.dataset.split("+"):
        dir_path = args.image_path.format(dataset)
        if not os.path.exists(dir_path):
            raise ValueError(f"Image path {dir_path} does not exist!")
        image_paths += ImageIO.list_dir_image(dir_path)
    image_paths = sorted(image_paths)
    logger.log(f"Found {len(image_paths)} images from {args.dataset}.")

    cache = ArrayCache(os.path.join(args.cache_path, args.dataset))
    if cache.mode == "r":
        # decided before the backbone runs: a complete cache opens read-only
        if not args.overwrite:
            logger.log(f"Pseudo-label cache at {cache.base_path} is already complete ({len(cache)} entries); pass "
                       "--overwrite to regenerate (required after changing --th_bkg or the image set)")
            return str(cache.base_path)
        cache.invalidate("--overwrite requested")
    size = (args.image_size, args.image_size)
    grid = args.image_size // fe.config.patch_size

    idx = 0
    for start in range(0, len(image_paths), args.batch_size):
        chunk = image_paths[start : start + args.batch_size]
        key_tokens, _, cls_attn = fe.extract_with_attention(load_image_batch_transform(chunk, size))
        with torch.inference_mode():
            bkg, _ = compute_background_mask(torch.from_numpy(cls_attn).to(fe.device),
                                             torch.from_numpy(key_tokens).to(fe.device), (grid, grid),
                                             th_bkg=args.th_bkg)
            fg = 1.0 - bkg.cpu().numpy()  # (B, h, w), 1 on candidate foreground
        for m in fg:
            cache.write(idx, refine_small_components(m)[:, :, None].astype(np.float32))
            idx += 1
        if (start // args.batch_size) % 10 == 0:
            logger.log(f"pseudo-labels: {idx}/{len(image_paths)}")
    stems = "\n".join(os.path.splitext(os.path.basename(str(p)))[0] for p in image_paths)
    # the dataset's cache identity (count and stem fingerprint), so that the
    # trainer notices an image set that changed under this positional cache
    cache.flush(meta={"n": idx, "fingerprint": hashlib.sha1(stems.encode()).hexdigest(), "th_bkg": args.th_bkg})
    logger.log(f"Generated {idx} pseudo labels into {cache.base_path}")
    return str(cache.base_path)


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
