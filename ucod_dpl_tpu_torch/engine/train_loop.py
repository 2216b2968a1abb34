"""Stage-1 training loop, host-side epoch orchestration, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.engine.train_loop` (the reference's
``TrainLoop``, ``engine/runner/loop_UCOD_DPL.py:36-272``), in the same
order: the epoch loop with discriminator inter-training every
``dis_intertrain`` epochs, the finetune switch in the last
``-start_finetune`` epochs (fresh optimizers, adversarial term off, EMA ramp
reset), model and full-state checkpoints, LookTwice validation with best-MAE
tracking, deferred preemption that saves the phase reached and resumes past
the batches already applied, and the LoRA branch (adapters on the
backbone's q/k/v trained from live pixels beside the decoder).

The steps of :mod:`.train_step` update their state in place on
``runner.device``; nothing moves to the CPU unless the Runner was built with
``device="cpu"``.  Full states are written in the JAX package's file format
(:mod:`.checkpoint`), so either package resumes the other's.  The Runner's
mesh decides the device and refuses LoRA with ``model > 1``; with ``seq >
1`` the LoRA step and the discriminator passes' adapted forward run
sequence-parallel.  Data
parallel over ``torch.distributed`` (one process per card, each on its
shard of every global batch): the steps keep the ranks equal (see
:mod:`.train_step`), process 0 writes every file while the others wait,
every rank resumes from the same file, the logged losses are global means,
and the ranks agree on a preemption signal every
``train_cfg.preempt_poll_interval`` batches and at every phase and epoch
boundary.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ucod_dpl_tpu_torch.models.convert import (
    lora_state_from_jax,
    lora_state_to_jax,
    snapshot,
    train_state_from_jax,
    train_state_to_jax,
    tree_map,
)
from ucod_dpl_tpu_torch.parallel.distributed import all_reduce_mean, barrier, is_main_process, process_count
from . import preempt
from .checkpoint import load_train_state, save_train_state
from .train_step import (
    init_train_state,
    make_discriminator_step,
    make_lora_optimizer,
    make_lora_train_step,
    make_train_step,
    restart_optimizers,
)


class TrainLoop:
    def __init__(self, cfg, runner):
        self.cfg = cfg
        self.runner = runner
        self.device = runner.device
        tc = cfg.train_cfg
        self.max_epoch = tc.max_epoch
        self.start_epoch = tc.get("start_epoch", 0)
        self.start_finetune = tc.get("start_finetune", -5)
        self.dis_intertrain = tc.get("dis_intertrain", 2)
        self.dis_epochs = tc.get("dis_epoch", 1)
        self.merge_method = tc.get("merge_method", "dis")
        self.log_interval = cfg.log_cfg.get("log_interval", 50)
        # batches between the ranks' agreements on a preemption signal (an
        # all-gather on the host): grace periods are tens of seconds, steps
        # milliseconds
        self.preempt_poll = max(int(tc.get("preempt_poll_interval", 16)), 1)

        vc = cfg.val_cfg
        self.enable_val = vc.get("enable_val", True)
        self.val_interval = vc.get("val_interval", 5)
        self.val_start = (
            self.max_epoch + vc.get("start_val", -50) if vc.get("start_val", -50) < 0 else vc.get("start_val")
        )
        sc = tc.get("save_cfg", {})
        self.save_interval = sc.get("save_interval", 5)
        self.save_start = (
            self.max_epoch + sc.get("start_save", -50) if sc.get("start_save", -50) < 0 else sc.get("start_save")
        )

        self._train_step = make_train_step(cfg)
        self._dis_step = make_discriminator_step(cfg)

        # LoRA joint training (model_cfg.lora.enable): adapters on the
        # backbone's q/k/v trained beside the decoder from live pixels
        lc = cfg.model_cfg.get("lora", {})
        self.lora_enabled = bool(lc.get("enable", False))
        if self.lora_enabled:
            if runner.mesh.shape.get("model", 1) > 1:
                raise NotImplementedError(
                    "LoRA training with a model-parallel mesh is not supported (the adapted backbone runs "
                    "replicated per data shard); set tpu_cfg.mesh.model to 1 and scale with data parallelism"
                )
            from ucod_dpl_tpu_torch.models.lora import init_lora, lora_forward

            fe = runner.feature_extractor
            rank, alpha = int(lc.get("rank", 2)), float(lc.get("alpha", 4.0))
            self.lora_params = tree_map(lambda t: t.requires_grad_(True),
                                        init_lora(cfg.get("seed", 42) + 3, fe.params, rank=rank))
            self.lora_opt = make_lora_optimizer(self.lora_params, cfg)
            # a seq mesh axis shards the adapted backbone's tokens in training
            # too: the ring carries its own backward (parallel/sp.py)
            self._lora_step = make_lora_train_step(cfg, fe.config, fe.compute_dtype, sp_shard=fe.sp_shard)

            # discriminator inter-training scores the features the stage-1
            # step scores it on: the live adapted backbone's, not the cached
            # base backbone's
            def lora_extract(lora_p, px):
                with torch.no_grad():
                    out = lora_forward(fe.params, lora_p, px, fe.config, rank=rank, alpha=alpha,
                                       compute_dtype=fe.compute_dtype, remat=False, sp_shard=fe.sp_shard)
                return out["key_features"].to(px.device).float()

            self._lora_extract = lora_extract

        self.state = init_train_state(runner.decoder_params, runner.decoder_ema_params,
                                      runner.discriminator_params, runner.discriminator_stats, tc, self.device)
        self.finetune = False
        self.best_mae = float("inf")
        self.best_result: Optional[Dict[str, float]] = None
        self.save_mode = sc.get("save_mode", "model")
        self.ckpt_backend = sc.get("backend", "npz")

        resume = tc.get("resume")
        if resume:
            self._resume(resume)

    def _resume(self, path: str) -> None:
        """Restore the full training state (optimizer moments, EMA step,
        epoch, phase progress) from a ``save_mode='all'`` or preemption
        checkpoint of either package."""
        tree, meta = load_train_state(path, train_state_to_jax(self.state))
        self.state = train_state_from_jax(tree, self.cfg.train_cfg, self.device)
        self.start_epoch = int(meta.get("epoch", 0))
        self.finetune = bool(meta.get("finetune", False))
        self.best_mae = float(meta.get("best_mae", float("inf")))
        # mid-epoch preemption: the phase of start_epoch that was running and
        # the batches it had applied, consumed once by run() so the resumed
        # run skips them instead of applying them again
        if meta.get("phase"):
            self._resume_phase = (str(meta["phase"]), int(meta.get("dis_pass", 0)), int(meta.get("batch_done", 0)))
        self._resume_val_pending = bool(meta.get("val_pending", False))
        if self.lora_enabled and (os.path.exists(path + "_lora.npz") or os.path.isdir(path + "_lora.orbax")):
            lora_tree, lora_meta = load_train_state(path + "_lora", lora_state_to_jax(self.lora_params, self.lora_opt))
            # both files carry the metadata of one save; a crash between the
            # two commits leaves adapters one save older than the decoder
            if lora_meta != meta:
                raise RuntimeError(
                    f"LoRA state {path}_lora is from a different save than {path} (meta {lora_meta} vs {meta}): "
                    "a crash likely interrupted the checkpoint pair; resume from the previous state_epochN "
                    "checkpoint instead"
                )
            self.lora_params, self.lora_opt = lora_state_from_jax(lora_tree, self.cfg, self.device)
        self.runner.logger.log(f"Resumed training state from {path} (epoch {self.start_epoch}, "
                               f"finetune={self.finetune})")

    def _save_full_state(self, path: str, epoch: int, phase_meta=None) -> None:
        """Write the state (and the adapters' pair file) from process 0; the
        others wait for it."""
        if is_main_process():
            self._write_full_state(path, epoch, phase_meta)
        barrier("full state")

    def _write_full_state(self, path: str, epoch: int, phase_meta=None) -> None:
        meta = {"epoch": epoch, "finetune": self.finetune, "best_mae": self.best_mae}
        if getattr(self, "_val_pending", False):
            # this boundary's validation has not run yet: a resume from this
            # checkpoint runs it again (see run())
            meta["val_pending"] = True
        if phase_meta:
            meta.update(phase_meta)
        save_train_state(path, train_state_to_jax(self.state), meta, backend=self.ckpt_backend)
        if self.lora_enabled:
            save_train_state(path + "_lora", lora_state_to_jax(self.lora_params, self.lora_opt), meta,
                             backend=self.ckpt_backend)

    # ------------------------------------------------------------------
    def _device_batch(self, batch, need_features: bool = True):
        plabels = batch["pseudo_label"]
        # collate passes Nones and ragged arrays through as a list: no usable cache
        if plabels is None or isinstance(plabels, list):
            raise RuntimeError(
                "Training requires a pseudo-label cache; run generate_pseudo_label first (python3 -m "
                "ucod_dpl_tpu_torch.cli generate_pseudo_label, or the JAX package's "
                "scripts/generate_pseudo_label.py: the same cache)."
            )
        plabels = torch.from_numpy(np.asarray(plabels, dtype=np.float32)).to(self.device)
        features = None
        if need_features:  # LoRA batches train from pixels: no cached features copied
            features = torch.from_numpy(np.asarray(batch["features"], dtype=np.float32)).to(self.device)
        return features, plabels

    def _device_pixels(self, batch) -> torch.Tensor:
        """Normalised image pixels on the device (the LoRA paths feed the
        live backbone from pixels)."""
        return torch.from_numpy(np.asarray(batch["pixels"], dtype=np.float32)).to(self.device)

    def _sync_runner_params(self) -> None:
        self.runner.decoder_params = snapshot(self.state.decoder)
        self.runner.decoder_ema_params = snapshot(self.state.decoder_ema)
        self.runner.discriminator_params = snapshot(self.state.dis_params)
        self.runner.discriminator_stats = snapshot(self.state.dis_stats)

    # ------------------------------------------------------------------
    def _maybe_preempt_exit(self, signum=None, batch_idx=None) -> None:
        """Save the full state and exit if a preemption signal was flagged.

        The handler (:func:`preempt.install`) only sets a flag; this runs at
        safe boundaries: after every step, between phases and epochs, and
        when a validation raises :class:`preempt.Preempted`.  The checkpoint
        records the phase progress of the current epoch (``phase``,
        ``dis_pass``, ``batch_done``) so that a resumed run skips the batches
        whose updates the saved state already holds.

        One process checks its own flag at every call.  With more, the ranks
        take the flag they agree on (:func:`preempt.requested_global`, a
        host all-gather): mid-phase calls pass ``batch_idx`` and agree only
        every ``preempt_poll_interval`` batches, the same arithmetic on
        every rank; phase and epoch boundaries always agree.  So every rank
        saves and exits at the same batch."""
        if signum is None:
            if process_count() == 1:
                signum = preempt.requested()
            elif batch_idx is None or batch_idx % self.preempt_poll == 0:
                signum = preempt.requested_global()
            else:
                return
        if signum is None:
            return
        path = f"{self.runner.ckp_dir}/state_preempt"
        phase = getattr(self, "_phase", None)
        phase_meta = {}
        if phase is not None:
            phase_meta = {"phase": phase[0], "dis_pass": phase[1], "batch_done": phase[2]}
        self._save_full_state(path, self._cur_epoch, phase_meta)
        self.runner.logger.log(f"Preemption signal {signum}: state saved to {path}; resume with --resume {path}")
        raise SystemExit(128 + signum)

    def _validate(self) -> None:
        self._sync_runner_params()
        try:
            result = self.runner.launch_val_look_twice()
        except preempt.Preempted as e:
            # the eval loop polls the flag per batch, so a long validation
            # cannot swallow the grace period; the train state is coherent
            self._maybe_preempt_exit(e.signum)
            raise  # unreachable: the exit raises SystemExit
        self._update_best(result)
        self._val_pending = False

    def run(self) -> None:
        logger = self.runner.logger
        logger.log(f"Starting training: {self.max_epoch} epochs")
        epoch = self.start_epoch
        self._cur_epoch = epoch
        self._phase = None
        self._val_pending = False
        preempt.install()
        if getattr(self, "_resume_val_pending", False):
            # the preempted run stopped at (or in) a boundary validation: run
            # it now, so best-MAE tracking follows the uninterrupted run
            self._resume_val_pending = False
            self._val_pending = True
            self._validate()
        while epoch < self.max_epoch:
            self._cur_epoch = epoch
            self._maybe_preempt_exit()
            if not self.finetune and epoch == self.max_epoch + self.start_finetune:
                self._enter_finetune()

            rp = getattr(self, "_resume_phase", None)
            resumed_in_train = rp is not None and rp[0] == "train" and epoch == self.start_epoch
            if (
                self.merge_method == "dis"
                and not self.finetune
                and epoch % self.dis_intertrain == 0
                # a preemption in the train phase came after this epoch's
                # discriminator inter-training: do not apply it again
                and not resumed_in_train
            ):
                self._train_discriminator(epoch)

            self._run_epoch(epoch)
            epoch += 1
            self._cur_epoch = epoch  # the saves and validation after an epoch belong to the boundary

            # flag the validation before any boundary save: a checkpoint
            # written before it ran records val_pending, so a resume from it
            # runs the validation again
            self._val_pending = self.enable_val and epoch >= self.val_start and epoch % self.val_interval == 0
            if epoch >= self.save_start and epoch % self.save_interval == 0:
                self._sync_runner_params()
                self.runner.save_checkpoint(epoch)
                if self.lora_enabled:
                    self._save_lora(epoch)
                if self.save_mode == "all":
                    self._save_full_state(f"{self.runner.ckp_dir}/state_epoch{epoch}", epoch)
            self._maybe_preempt_exit()

            if self._val_pending:
                self._validate()

        self._sync_runner_params()
        if self.best_result is not None:
            logger.log(f"Best result: {self.best_result}")

    def _save_lora(self, epoch: int) -> None:
        """The adapters and the backbone with them merged densely (the
        HuggingFace layout, which eval and serving load through the ordinary
        ``backbone_weights`` path at the base model's cost).  The merge takes
        the backbone's float32 weights, as the JAX package's does.  Process
        0 writes; the others wait for it."""
        if is_main_process():
            self._write_lora(epoch)
        barrier("lora save")

    def _write_lora(self, epoch: int) -> None:
        from ucod_dpl_tpu_torch.models.lora import save_lora_checkpoint, save_merged_backbone

        lc = self.cfg.model_cfg.lora
        fe = self.runner.feature_extractor
        adapters = f"{self.runner.ckp_dir}/lora_epoch{epoch}.safetensors"
        merged = f"{self.runner.ckp_dir}/backbone_merged_epoch{epoch}.safetensors"
        save_lora_checkpoint(adapters, self.lora_params)
        save_merged_backbone(merged, fe.float32_params(), self.lora_params, fe.config,
                             rank=int(lc.get("rank", 2)), alpha=float(lc.get("alpha", 4.0)))
        self.runner.logger.log(f"Saved LoRA adapters {adapters} + merged backbone {merged}")

    def _enter_finetune(self) -> None:
        """The finetune switch (loop:100-103, runner.start_finetune): fresh
        optimizers (the LR schedules restart at lr0), EMA ramp reset,
        adversarial term off."""
        self.finetune = True
        self.runner.logger.log("Entering finetune phase: optimizers rebuilt, APM off")
        restart_optimizers(self.state, self.cfg.train_cfg)
        if self.lora_enabled:
            # the adapters' schedule restarts with the other optimizers
            self.lora_opt = make_lora_optimizer(self.lora_params, self.cfg)

    def _run_epoch(self, epoch: int) -> None:
        logger = self.runner.logger
        adv = 0.0 if self.finetune else 1.0
        t0 = time.perf_counter()
        last_aux = None
        # batch order = f(seed, epoch): a resumed run replays the same order
        self.runner.train_dataloader.set_epoch(epoch)
        n = self._consume_resume_skip("train", epoch)
        for batch in self.runner.train_dataloader:
            features, plabels = self._device_batch(batch, need_features=not self.lora_enabled)
            if self.lora_enabled:
                aux = self._lora_step(self.state, self.lora_params, self.lora_opt,
                                      self.runner.feature_extractor.params, self._device_pixels(batch), plabels,
                                      float(epoch), adv)
            else:
                aux = self._train_step(self.state, features, plabels, float(epoch), adv)
            last_aux = aux
            n += 1
            self._phase = ("train", 0, n)
            self._maybe_preempt_exit(batch_idx=n)
            if n % max(self.log_interval, 1) == 0:
                loss, dis, w = (float(all_reduce_mean(aux[k])) for k in ("loss", "dis_loss", "merge_weight"))
                logger.log(f"epoch {epoch} iter {n}: loss={loss:.4f} dis={dis:.4f} w={w:.2f}")
        self._phase = None
        dt = time.perf_counter() - t0
        if last_aux is not None:
            loss = float(all_reduce_mean(last_aux["loss"]))
            logger.log(f"epoch {epoch} done: {n} iters in {dt:.1f}s ({n / max(dt, 1e-9):.2f} it/s), "
                       f"loss={loss:.4f}")

    def _consume_resume_skip(self, phase: str, epoch: int, dis_pass: int = 0) -> int:
        """Batches of (phase, epoch[, dis_pass]) the preempted run already
        applied: skip them in the loader (once) and start the batch counter
        there.  0 when this is not the resumed phase."""
        rp = getattr(self, "_resume_phase", None)
        if rp is None or epoch != self.start_epoch or rp[0] != phase:
            return 0
        if phase == "dis" and rp[1] != dis_pass:
            return 0
        self._resume_phase = None
        if rp[2]:
            self.runner.train_dataloader.skip_batches(rp[2])
            self.runner.logger.log(f"Resume: skipping {rp[2]} already-applied {phase} batches of epoch {epoch}")
        return rp[2]

    def _train_discriminator(self, epoch: int) -> None:
        logger = self.runner.logger
        rp = getattr(self, "_resume_phase", None)
        start_pass = rp[1] if rp is not None and rp[0] == "dis" and epoch == self.start_epoch else 0
        for d in range(start_pass, self.dis_epochs):
            losses = []
            # a distinct deterministic order for each discriminator pass
            self.runner.train_dataloader.set_epoch(1_000_000 + epoch * 100 + d)
            n = self._consume_resume_skip("dis", epoch, dis_pass=d)
            for batch in self.runner.train_dataloader:
                features, plabels = self._device_batch(batch, need_features=not self.lora_enabled)
                if self.lora_enabled:
                    features = self._lora_extract(self.lora_params, self._device_pixels(batch))
                aux = self._dis_step(self.state, features, plabels)
                losses.append(aux["dis_train_loss"])
                n += 1
                self._phase = ("dis", d, n)
                self._maybe_preempt_exit(batch_idx=n)
            if losses:
                mean = float(all_reduce_mean(torch.stack(losses).mean()))
                logger.log(f"epoch {epoch}: discriminator pass mean loss {mean:.4f}")
        self._phase = None

    def _update_best(self, result: Dict[str, float]) -> None:
        if result["MAE"] < self.best_mae:
            self.best_mae = result["MAE"]
            self.best_result = result
            self.runner.logger.log("best result:")
            self.runner.logger.log_table({k: [round(v, 4)] for k, v in result.items()})
