"""Training steps for UCOD-DPL stage 1 in PyTorch.

Counterpart of :mod:`ucod_dpl_tpu.engine.train_step` (the reference
``engine/runner/loop_UCOD_DPL.py``):

  * :func:`make_train_step`: teacher (EMA) forward, student forward with the
    orthogonality loss, the APM pseudo-label merge through the discriminator
    (``merge_pseudo_label``, loop:257-272), BCE-with-logits losses
    (loop:164-173), AdamW with the per-batch StepLR (loop:179) and the EMA
    teacher update with its alpha ramp (loop:186-191), on cached features;
  * :func:`make_lora_train_step`: the same loss from pixels through the
    LoRA-adapted backbone, with gradients to the decoder and the adapters;
  * :func:`make_discriminator_step`: the discriminator inter-training step
    (``Discriminator_epoch``, loop:230-255).

Reference quirks kept deliberately (as in the JAX package):
  * the adversarial term enters the decoder loss through *binarised* student
    masks, so it carries no gradient: it only shifts the reported loss;
  * ``ema_step`` advances twice per batch (loop:143 + loop:182), which is
    what the EMA alpha ramp sees;
  * the LR scheduler steps once per *batch*: lr = lr0 * gamma^(batch // 25);
  * ``max_epoch + start_finetune == 0`` is refused (the merge ramp divides
    by it).

PyTorch idiom in place of the JAX package's pure functions: a step updates
its :class:`TrainState` (and the adapters) in place and returns the scalars
it reports.  Gradients stay in the parameters' ``.grad`` until the next
step, for inspection.

Data parallel (a ``torch.distributed`` group): each rank steps on its local
batch; :class:`Optimizer` averages the gradients over the ranks and the
discriminator takes its batch-norm moments over the global batch, so the
ranks take the step of the mean loss over the concatenated global batch
and stay equal.  The returned scalars are the rank's own.  Sequence
parallel across processes (:func:`make_lora_train_step` on a mesh over
processes): the same, with the ``seq`` ranks of a data coordinate feeding
the same rows (see there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ucod_dpl_tpu_torch.models.convert import tree_leaves, tree_map
from ucod_dpl_tpu_torch.models.dba import RevDecoderParams, rev_decoder_forward
from ucod_dpl_tpu_torch.models.discriminator import discriminator_forward
from ucod_dpl_tpu_torch.ops.resize import interpolate_bilinear
from ucod_dpl_tpu_torch.parallel.distributed import LOCAL, all_reduce_mean_, all_reduce_sum_
from ucod_dpl_tpu_torch.parallel.mesh import data_sharding


class Optimizer:
    """AdamW (torch's, with the reference's betas, eps and weight decay) and
    the reference's StepLR, stepped once per batch; without ``step_size`` no
    schedule (the caller sets the rate with :meth:`set_lr`).  A parameter
    that got no gradient (the last layer's q/v adapters, whose outputs the
    forward never computes) is stepped with a zero gradient, as optax steps
    it: its weight decay still applies.  In a data-parallel run the
    gradients are averaged over the ranks first, in one bucket
    (:func:`~ucod_dpl_tpu_torch.parallel.distributed.all_reduce_mean_`)
    over the group :meth:`step` is given."""

    def __init__(self, params: Iterable[torch.Tensor], lr0: float, gamma: float = 1.0,
                 step_size: Optional[int] = None):
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
        self.schedule = None if step_size is None else torch.optim.lr_scheduler.StepLR(
            self.adamw, step_size=step_size, gamma=gamma)

    def set_lr(self, lr: float) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = lr

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self, group=None, sum_group=LOCAL) -> None:
        """One AdamW (and StepLR) step, the gradients first summed over
        ``sum_group`` (each rank holds a share of them; none by default),
        then averaged over ``group`` (the default group when None)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        all_reduce_sum_(grads, sum_group)
        # data parallel: the gradient of the mean loss over the global batch
        all_reduce_mean_(grads, group)
        self.adamw.step()
        if self.schedule is not None:
            self.schedule.step()

    @property
    def count(self) -> int:
        """Steps taken: AdamW's per-parameter ``step``, one value for all
        (every parameter is stepped every time), 0 before the first step."""
        steps = {int(self.adamw.state[p]["step"]) for p in self.params if p in self.adamw.state}
        if len(steps) > 1:
            raise RuntimeError(f"AdamW parameters at different step counts {sorted(steps)}")
        return steps.pop() if steps else 0

    def moments(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """AdamW's first and second moments, one per parameter in order
        (zeros before the first step)."""
        st = self.adamw.state
        return ([st[p]["exp_avg"] if p in st else torch.zeros_like(p) for p in self.params],
                [st[p]["exp_avg_sq"] if p in st else torch.zeros_like(p) for p in self.params])

    def load(self, count: int, exp_avg: Sequence[torch.Tensor], exp_avg_sq: Sequence[torch.Tensor],
             schedule_count: int) -> None:
        """Resume at ``count`` AdamW steps with the given moments and at
        ``schedule_count`` StepLR steps.  The learning rate is replayed the
        way StepLR reaches it (one multiplication by gamma every step_size
        steps), so a resumed run takes the uninterrupted run's rates bit for
        bit."""
        self.adamw.state.clear()
        if count:
            for p, m, v in zip(self.params, exp_avg, exp_avg_sq, strict=True):
                self.adamw.state[p] = {"step": torch.tensor(float(count)),
                                       "exp_avg": m.to(p.device, torch.float32).clone(),
                                       "exp_avg_sq": v.to(p.device, torch.float32).clone()}
        sched = self.schedule
        lrs = list(sched.base_lrs)
        for i in range(1, schedule_count + 1):
            if i % sched.step_size == 0:
                lrs = [lr * sched.gamma for lr in lrs]
        for group, lr in zip(self.adamw.param_groups, lrs):
            group["lr"] = lr
        sched.last_epoch = schedule_count
        sched._last_lr = lrs


def make_optimizer(params: Iterable[torch.Tensor], lr0: float, gamma: float, step_size: int) -> Optimizer:
    """AdamW with lr = lr0 * gamma ** (batch // step_size) over ``params``."""
    return Optimizer(params, lr0, gamma, step_size)


@dataclass
class TrainState:
    decoder: RevDecoderParams  # leaves require grad
    decoder_ema: RevDecoderParams
    opt: Optimizer
    dis_params: Dict[str, Any]  # leaves require grad
    dis_stats: Dict[str, Any]
    dis_opt: Optimizer
    ema_step: int = 0  # the reference's double-incrementing global_step


def init_train_state(
    decoder: RevDecoderParams,
    decoder_ema: RevDecoderParams,
    dis_params: Dict[str, Any],
    dis_stats: Dict[str, Any],
    train_cfg,
    device,
) -> TrainState:
    """A state on ``device`` holding copies of the given trees, with the
    decoder and discriminator optimizers of ``train_cfg`` (``lr0``,
    ``step_lr_gamma``/``step_lr_size``, ``dis_lr0``,
    ``dis_step_lr_gamma``/``dis_step_lr_size``; the JAX train loop's)."""

    def trainable(tree):
        return tree_map(lambda t: t.detach().to(device, torch.float32).clone().requires_grad_(True), tree)

    def fixed(tree):
        return tree_map(lambda t: t.detach().to(device, torch.float32).clone(), tree)

    decoder, dis_params = trainable(decoder), trainable(dis_params)
    return TrainState(
        decoder=decoder,
        decoder_ema=fixed(decoder_ema),
        opt=_decoder_optimizer(decoder, train_cfg),
        dis_params=dis_params,
        dis_stats=fixed(dis_stats),
        dis_opt=_dis_optimizer(dis_params, train_cfg),
    )


def _decoder_optimizer(decoder: RevDecoderParams, tc) -> Optimizer:
    return make_optimizer(tree_leaves(decoder), tc.lr0, tc.get("step_lr_gamma", 0.95), tc.get("step_lr_size", 25))


def _dis_optimizer(dis_params: Dict[str, Any], tc) -> Optimizer:
    return make_optimizer(tree_leaves(dis_params), tc.get("dis_lr0", 1e-3), tc.get("dis_step_lr_gamma", 0.95),
                          tc.get("dis_step_lr_size", 25))


def make_lora_optimizer(lora, cfg) -> Optimizer:
    """The adapters' AdamW: ``model_cfg.lora.lr`` on the decoder's StepLR
    schedule (``train_cfg.step_lr_gamma``/``step_lr_size``), as the JAX
    train loop builds it."""
    tc = cfg.train_cfg
    return make_optimizer(tree_leaves(lora), cfg.model_cfg.lora.get("lr", 1e-4), tc.get("step_lr_gamma", 0.95),
                          tc.get("step_lr_size", 25))


def restart_optimizers(state: TrainState, train_cfg) -> None:
    """The finetune switch (the JAX train loop's ``_enter_finetune``): new
    AdamW and StepLR objects over the same parameter tensors, so moments
    start from zero and the rate from ``lr0`` again, and the EMA ramp
    restarts (``ema_step`` 0)."""
    state.opt = _decoder_optimizer(state.decoder, train_cfg)
    state.dis_opt = _dis_optimizer(state.dis_params, train_cfg)
    state.ema_step = 0


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCEWithLogitsLoss (numerically stable)."""
    x, z = logits, targets
    return torch.mean(torch.clamp(x, min=0) - x * z + torch.log1p(torch.exp(-torch.abs(x))))


def bce_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCELoss on probabilities, logs clamped at -100 like torch."""
    logp = torch.clamp(torch.log(probs), min=-100.0)
    log1mp = torch.clamp(torch.log1p(-probs), min=-100.0)
    return -torch.mean(targets * logp + (1.0 - targets) * log1mp)


def _to_feature_size(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w, c) -> (B, size, size, c) bilinear (loop:152-154)."""
    return interpolate_bilinear(x.permute(0, 3, 1, 2), (size, size)).permute(0, 2, 3, 1)


def _merge_denominator(cfg) -> float:
    tc = cfg.train_cfg
    denom = tc.max_epoch + tc.get("start_finetune", -5)
    if denom == 0:
        # epoch / 0 would NaN-poison every parameter from the first step
        raise ValueError(
            f"train_cfg.max_epoch ({tc.max_epoch}) + start_finetune ({tc.get('start_finetune', -5)}) "
            "must be nonzero (the APM merge ramp divides by it); adjust max_epoch or start_finetune"
        )
    return denom


def _stage1_decoder_loss(
    dec_params: RevDecoderParams,
    state: TrainState,
    f: torch.Tensor,  # (B, fs, fs, C) features at feature_size
    pl: torch.Tensor,  # (B, fs, fs, 1) pseudo-labels at feature_size
    teacher_bin: torch.Tensor,
    epoch: float,
    adv_coeff: float,
    use_dis_merge: bool,
    denom: float,
    f_apm: torch.Tensor = None,
    group=None,
):
    """The stage-1 student loss (loop:164-173 + merge_pseudo_label
    loop:257-272), shared by the cached-feature and LoRA steps.  ``f_apm``
    (default ``f``) feeds the discriminator, whose batch-norm moments run
    over the ranks of ``group``; the APM merge builds the training target,
    so it runs without gradient and leaves the BN running statistics as
    they are."""
    if f_apm is None:
        f_apm = f
    fg, bg_rev, ortho = rev_decoder_forward(dec_params, f, with_loss=True)
    with torch.no_grad():
        if use_dis_merge:
            student_bin = (torch.sigmoid(fg) > 0.5).float()
            p_s, _ = discriminator_forward(state.dis_params, state.dis_stats, student_bin, f_apm, group=group)
            p_p, _ = discriminator_forward(state.dis_params, state.dis_stats, (pl > 0.5).float(), f_apm, group=group)
            w = 0.5 * (1.0 + torch.cos(torch.abs(p_s - p_p) * math.pi)) + epoch / denom
            w = torch.clamp(w, 0.0, 1.0)[:, :, None, None]  # (B, 1, 1, 1)
            merged = pl * (1.0 - w) + teacher_bin * w
            dis_loss = bce_probs(p_s, torch.zeros_like(p_s))
        else:
            merged = pl
            dis_loss = torch.zeros((), device=f.device)
            w = torch.zeros((1, 1, 1, 1), device=f.device)
            p_s = p_p = torch.zeros((1, 1), device=f.device)

    loss = bce_with_logits(fg, merged)
    # adversarial term: gradient-free through the binarisation, kept for
    # loss parity with the reference (loop:167-169)
    loss = loss - adv_coeff * dis_loss
    loss = loss + bce_with_logits(bg_rev, 1.0 - merged)
    loss = loss + ortho
    aux = {
        "dis_loss": dis_loss,
        "ortho_loss": ortho.detach(),
        "merge_weight": torch.mean(w),
        "p_s": torch.mean(p_s),
        "p_p": torch.mean(p_p),
    }
    return loss, aux


@torch.no_grad()
def _ema_update(state: TrainState, ema_weight: float) -> None:
    """EMA after the optimizer step; alpha ramps on the double-incrementing
    step (loop:186-191)."""
    alpha = min(1.0 - 1.0 / (state.ema_step + 1.0), ema_weight)
    for e, p in zip(tree_leaves(state.decoder_ema), tree_leaves(state.decoder)):
        e.mul_(alpha).add_(p, alpha=1.0 - alpha)
    state.ema_step += 2


@torch.no_grad()
def _teacher_bin(state: TrainState, f: torch.Tensor) -> torch.Tensor:
    teacher_fg, _, _ = rev_decoder_forward(state.decoder_ema, f, with_loss=False)
    return (torch.sigmoid(teacher_fg) > 0.5).float()


def make_train_step(cfg):
    """The stage-1 step on cached features:
    ``step(state, features (B, fh, fw, C), pseudo_labels (B, ph, pw, 1),
    epoch, adv_coeff) -> aux``, updating ``state`` in place."""
    feature_size = cfg.model_cfg.feature_size
    ema_weight = cfg.model_cfg.ema_weight
    use_dis_merge = cfg.train_cfg.get("merge_method", "dis") == "dis"
    denom = _merge_denominator(cfg)

    def step(state: TrainState, features, pseudo_labels, epoch: float, adv_coeff: float):
        f = _to_feature_size(features, feature_size)
        pl = _to_feature_size(pseudo_labels.float(), feature_size)
        teacher_bin = _teacher_bin(state, f)
        state.opt.zero_grad()
        loss, aux = _stage1_decoder_loss(state.decoder, state, f, pl, teacher_bin, epoch, adv_coeff,
                                         use_dis_merge, denom)
        loss.backward()
        state.opt.step()
        _ema_update(state, ema_weight)
        aux["loss"] = loss.detach()
        return aux

    return step


def make_lora_train_step(cfg, dino_cfg, compute_dtype: torch.dtype, *, plain: bool = False, sp_shard=None):
    """The stage-1 step with a live LoRA-adapted backbone:
    ``step(state, lora, lora_opt, backbone_params, pixels (B, H, W, 3),
    pseudo_labels, epoch, adv_coeff) -> aux``, updating ``state``, ``lora``
    and ``lora_opt`` in place.

    pixels -> adapted backbone key features (``lora_forward``, attention
    through the forward-LSE and backward kernels; ``plain=True`` runs their
    plain PyTorch versions) -> bilinear resize to ``feature_size`` -> the
    stage-1 student loss.  The APM merge and the EMA teacher see detached
    features.  Gradients reach the decoder and the adapters only (the
    backbone's tensors do not require grad).  ``cfg.model_cfg.lora`` gives
    ``rank``, ``alpha`` and ``remat`` (``"none"``/``False``,
    ``"layer"``/``True`` or ``"dots"``).

    ``sp_shard``: ``(mesh, "seq")``: the adapted backbone runs
    sequence-parallel (``dino_forward(sp_shard=)``: ring attention through
    the forward-LSE and backward kernels per chunk pair), on the devices of
    the mesh's data coordinate 0, with the whole batch; the key features
    are gathered on the device of ``pseudo_labels``, where the decoder
    runs.  The scaling lever for fine-tuning at 756px and above.

    On a mesh over processes (the JAX step on a global mesh whose ``seq``
    axis spans processes) every process calls the step with the same
    global batch and takes the rows of its data coordinates
    (:func:`~ucod_dpl_tpu_torch.parallel.mesh.data_sharding`); the ``seq``
    ranks of a data coordinate feed the same rows, each running its token
    chunks, the ring crossing processes, and compute the same loss on the
    gathered key features.  The step then takes the gradient of the mean
    loss over the global batch: the LoRA gradients (each ``seq`` rank holds
    its chunks' share) summed over the ``seq`` group, then averaged over
    the ``data`` group; the decoder's (whole on every ``seq`` rank) averaged
    over the ``data`` group; the discriminator's batch-norm moments run over
    the ``data`` group.  Every rank ends each step with the same state.  A
    ``model`` axis, inside the processes or across them, is not used: the
    step runs replicated over it (each model coordinate's processes step as
    one of them would; in a process, on its first model coordinate's
    devices), as the JAX step's ring, whose specs name no ``model`` axis,
    runs replicated over it.  The returned scalars are the process's own
    (its rows' loss); ``lora_grad_norm`` is the global one.

    ``step.loss_fn(state, lora, backbone_params, pixels, pseudo_labels,
    epoch, adv_coeff) -> (loss, aux)`` is the differentiable loss alone (on
    a mesh over processes, of this process's rows)."""
    from ucod_dpl_tpu_torch.models.lora import lora_forward

    feature_size = cfg.model_cfg.feature_size
    ema_weight = cfg.model_cfg.ema_weight
    use_dis_merge = cfg.train_cfg.get("merge_method", "dis") == "dis"
    denom = _merge_denominator(cfg)
    lc = cfg.model_cfg.lora
    rank = int(lc.get("rank", 2))
    alpha = float(lc.get("alpha", 4.0))
    remat = lc.get("remat", True)
    mesh = sp_shard[0] if sp_shard is not None and sp_shard[0].spans_processes else None
    data_group, seq_group = None, LOCAL  # without a mesh over processes: data parallel over the world
    if mesh is not None:
        block = mesh.local_block()
        data_coords = block.get("data", [0])
        data_group, seq_group = mesh.group("data"), mesh.group(sp_shard[1])

    def rows(batch: torch.Tensor) -> torch.Tensor:
        """This process's rows of the global batch (all without a mesh over
        processes)."""
        if mesh is None:
            return batch
        slices = data_sharding(mesh, batch.shape[0])
        first, last = slices[data_coords[0]], slices[data_coords[-1]]
        return batch if first == slice(None) else batch[first.start:last.stop]

    def loss_fn(state: TrainState, lora, backbone_params, pixels, pseudo_labels, epoch: float, adv_coeff: float):
        pixels, pseudo_labels = rows(pixels), rows(pseudo_labels)
        pl = _to_feature_size(pseudo_labels.float(), feature_size)
        out = lora_forward(backbone_params, lora, pixels, dino_cfg, rank=rank, alpha=alpha,
                           compute_dtype=compute_dtype, remat=remat, plain=plain, sp_shard=sp_shard)
        f = _to_feature_size(out["key_features"].to(pl.device).float(), feature_size)
        f_sg = f.detach()
        return _stage1_decoder_loss(state.decoder, state, f, pl, _teacher_bin(state, f_sg), epoch, adv_coeff,
                                    use_dis_merge, denom, f_apm=f_sg, group=data_group)

    def step(state: TrainState, lora, lora_opt: Optimizer, backbone_params, pixels, pseudo_labels,
             epoch: float, adv_coeff: float):
        state.opt.zero_grad()
        lora_opt.zero_grad()
        loss, aux = loss_fn(state, lora, backbone_params, pixels, pseudo_labels, epoch, adv_coeff)
        loss.backward()
        state.opt.step(group=data_group)
        lora_opt.step(group=data_group, sum_group=seq_group)
        aux["lora_grad_norm"] = torch.sqrt(sum(torch.sum(t.grad.float() ** 2) for t in tree_leaves(lora)))
        _ema_update(state, ema_weight)
        aux["loss"] = loss.detach()
        return aux

    step.loss_fn = loss_fn
    return step


def make_discriminator_step(cfg):
    """The discriminator inter-training step (Discriminator_epoch,
    loop:230-255): student masks are 'fake' (0), pseudo-labels 'real' (1).
    ``step(state, features, pseudo_labels) -> aux``, updating the
    discriminator's params, running statistics and optimizer in place."""
    feature_size = cfg.model_cfg.feature_size

    def step(state: TrainState, features, pseudo_labels):
        f = _to_feature_size(features, feature_size)
        with torch.no_grad():
            fg, _, _ = rev_decoder_forward(state.decoder, f, with_loss=False)
            student_bin = (torch.sigmoid(fg) > 0.5).float()
            pl_bin = (_to_feature_size(pseudo_labels.float(), feature_size) > 0.5).float()
        state.dis_opt.zero_grad()
        probs_student, stats1 = discriminator_forward(state.dis_params, state.dis_stats, student_bin, f)
        probs_pseudo, stats2 = discriminator_forward(state.dis_params, stats1, pl_bin, f)
        probs = torch.cat([probs_student, probs_pseudo], dim=0)
        targets = torch.cat([torch.zeros_like(probs_student), torch.ones_like(probs_pseudo)], dim=0)
        loss = bce_probs(probs, targets)
        loss.backward()
        state.dis_opt.step()
        state.dis_stats = stats2
        return {"dis_train_loss": loss.detach()}

    return step
