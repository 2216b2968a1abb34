"""Runner: builds the objects of a run and dispatches its loop, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.engine.runner` (the reference's
``StandardRunner``, ``engine/runner/runner.py``): directories and logger, the
device mesh from ``tpu_cfg.mesh``, the feature extractor in
``tpu_cfg.compute_dtype`` on ``device``, decoder and discriminator params
(seeded, or a checkpoint), the val dataloader, the config dump, checkpoints,
and the stage-1 LookTwice evaluation.  Stage-1 training through the Runner
is ROADMAP Queue 1 item 12; the CORAL stage-2 runner is item 15.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch

from ucod_dpl_tpu_torch.data.dataset import DataLoader
from ucod_dpl_tpu_torch.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu_torch.models.dba import init_rev_decoder
from ucod_dpl_tpu_torch.models.discriminator import init_discriminator
from ucod_dpl_tpu_torch.models.safetensors_io import load_decoder_checkpoint, save_decoder_checkpoint
from ucod_dpl_tpu_torch.parallel.distributed import maybe_initialize_distributed
from ucod_dpl_tpu_torch.parallel.mesh import build_mesh
from ucod_dpl_tpu_torch.utils.logger import Logger
from ucod_dpl_tpu_torch.utils.registry import DATASETS


def resolve_compute_dtype(cfg) -> Optional[torch.dtype]:
    """``tpu_cfg.compute_dtype`` as a torch dtype (None when unset: the
    extractor's default for its device)."""
    name = cfg.get("tpu_cfg", {}).get("compute_dtype")
    return getattr(torch, name) if name else None


class Runner:
    """Stage-1 (UCOD-DPL) runner: student and EMA decoder, discriminator."""

    def __init__(
        self,
        cfg,
        mode: str = "train",
        load_from: Optional[str] = None,
        feature_extractor: Optional[FeatureExtractor] = None,
        device="cuda",
    ):
        """``feature_extractor``: one built before, shared across Runners
        (the eval entry builds one Runner per test set).  ``device``: where
        the backbone and decoder run; the card unless the caller asks for
        the CPU (``"cpu"``).  On CUDA the mesh takes every visible card."""
        self.cfg = cfg
        self.mode = mode
        maybe_initialize_distributed()
        self._setup_dirs()
        self.logger = Logger(
            "ucod", log_file=os.path.join(self.log_path, "run.log"), ranks=cfg.log_cfg.get("multi_rank", [0])
        )
        device = torch.device(device)
        self.mesh = build_mesh(
            cfg.get("tpu_cfg", {}).get("mesh"), devices=None if device.type == "cuda" else [device]
        )
        self.feature_extractor = feature_extractor or FeatureExtractor(
            cfg.dataset_cfg.feature_extractor_cfg, compute_dtype=resolve_compute_dtype(cfg), mesh=self.mesh
        )
        self.device = self.feature_extractor.device
        self._build_model(load_from)
        self._build_dataloaders()
        self._dump_config()
        self.evaluator = None

    # -- setup -------------------------------------------------------------------
    def _setup_dirs(self) -> None:
        self.work_dir = self.cfg.get("work_dir", "./work")
        self.log_path = self.cfg.log_cfg.get("log_path") or os.path.join(self.work_dir, "logs")
        self.cfg.log_cfg.log_path = self.log_path
        self.ckp_dir = os.path.join(self.log_path, "ckp")
        os.makedirs(self.ckp_dir, exist_ok=True)

    def _build_model(self, load_from: Optional[str]) -> None:
        """Decoder towers from ``load_from`` or seeded (student from
        ``seed``, EMA teacher from ``seed + 1``, independent as the
        reference's two RevDecoders are), the discriminator from ``seed + 2``;
        all on the CPU, float32."""
        mc = self.cfg.model_cfg
        seed = self.cfg.get("seed", 42)
        if load_from:
            path = self._resolve_checkpoint(load_from)
            self.logger.log(f"Loading decoder checkpoint from {path}")
            self.decoder_params, self.decoder_ema_params = load_decoder_checkpoint(path)
        else:
            self.decoder_params = init_rev_decoder(seed, mc.dim)
            self.decoder_ema_params = init_rev_decoder(seed + 1, mc.dim)
        self.discriminator_params, self.discriminator_stats = init_discriminator(
            seed + 2, feature_size=mc.feature_size, feature_dim=mc.dim,
            use_features=mc.get("dis_use_features", False),
        )

    def _make_dataset(self, set_cfg, ds_mode: str, keep_size: bool):
        dc = self.cfg.dataset_cfg
        extra = {}
        if "cache_build_batch" in set_cfg:
            extra["cache_build_batch"] = int(set_cfg["cache_build_batch"])
        return DATASETS.get(set_cfg.get("type", "USCODDataset"))(
            set_cfg,
            dc.feature_extractor_cfg,
            dataset_dir=dc.dataset_dir,
            cache_dir=dc.cache_dir,
            mode=ds_mode,
            keep_size=keep_size,
            image_size=tuple(set_cfg.get("image_size", (518, 518))),
            require_label=set_cfg.get("require_label", False),
            feature_extractor=self.feature_extractor,
            logger=self.logger,
            **extra,
        )

    def _build_dataloaders(self) -> None:
        """The val dataloader (the train one comes with the train loop,
        ROADMAP Queue 1 item 12)."""
        dc = self.cfg.dataset_cfg
        valset_cfg = dc.valset_cfg
        keep_size = valset_cfg.get("keep_size", self.mode != "train")
        # the reference builds its val loaders with mode "test", so the caches
        # land under features_cache/{extractor}/test/{DATASET}
        self.val_dataset = self._make_dataset(valset_cfg, "test", keep_size=keep_size)
        self.val_dataloader = DataLoader(self.val_dataset, batch_size=dc.val_loader_cfg.get("batch_size", 1))

    def _dump_config(self) -> None:
        try:
            self.cfg.dump_yaml(os.path.join(self.log_path, "config.yaml"))
        except Exception as e:  # a run never fails over its config dump (yaml missing, say)
            self.logger.warning(f"Could not dump config: {e!r}")

    # -- checkpoints ---------------------------------------------------------------
    def _resolve_checkpoint(self, path: str) -> str:
        p = Path(path)
        if p.is_dir():
            inner = p / "model.safetensors"
            if inner.exists():
                return str(inner)
            cands = sorted(
                list(p.glob("*.safetensors")) + list(p.glob("*.pth")) + list(p.glob("*.pt")),
                key=lambda f: f.stat().st_mtime,
            )
            if cands:
                return str(cands[-1])
            raise FileNotFoundError(f"No checkpoint found under {path}")
        return str(p)

    def save_checkpoint(self, epoch: int) -> str:
        path = os.path.join(self.ckp_dir, f"epoch{epoch}.safetensors")
        save_decoder_checkpoint(path, self.decoder_params, self.decoder_ema_params)
        self.logger.log(f"Saved checkpoint {path}")
        return path

    def load_latest_checkpoint(self) -> Optional[str]:
        cands = sorted(Path(self.ckp_dir).glob("epoch*.safetensors"), key=lambda f: f.stat().st_mtime)
        if not cands:
            return None
        path = str(cands[-1])
        self.decoder_params, self.decoder_ema_params = load_decoder_checkpoint(path)
        return path

    # -- loops -----------------------------------------------------------------------
    def launch_val_look_twice(self) -> Dict[str, float]:
        """Stage-1 LookTwice evaluation of the val set; the evaluator stays
        in ``self.evaluator`` (its crop count and host time)."""
        from ucod_dpl_tpu_torch.engine import preempt
        from ucod_dpl_tpu_torch.engine.eval_loop import LookTwiceEvaluator

        self.evaluator = LookTwiceEvaluator(self.cfg, self)
        try:
            return self.evaluator.run()
        except preempt.Preempted:
            raise  # an orderly preemption, not a failure
        except Exception as e:
            self.logger.error(f"Validation failed: {e!r}")
            raise

    def launch_train(self) -> None:
        raise NotImplementedError("stage-1 training through the Runner is ROADMAP Queue 1 item 12")


class LocalRefineRunner(Runner):
    """CORAL stage-2 runner (frozen stage-1 decoder + UDLR refiner)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the CORAL stage-2 runner is ROADMAP Queue 1 item 15")
