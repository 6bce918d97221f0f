"""Training loop for the fusion classifier, the port of ``mmer_tpu/train/loop.py``.

One trainer.  The JAX package states the same semantics three times (an
epoch loop, a whole-run ``lax.while_loop`` and a streaming variant) to avoid
round trips through its device relay; on a PCIe-attached GPU an epoch loop on
the host with device-resident data is enough:

- the **whole dataset lives in device memory** as dense padded arrays; a
  minibatch is an on-device gather of a slice of the epoch's permuted index.
  Nothing crosses host→device inside an epoch, and the host reads one scalar
  (the mean loss) per epoch, never one per step;
- the tail batch is padded with −1 sentinels that gather sample 0 under a
  ``sample_weight`` of 0, as the JAX epoch does: loss and gradient equal the
  ragged batch's, and a batchnorm model sees the same rows in its batch
  statistics as the JAX model does;
- evaluation reduces a split to (weighted mean loss, C×C confusion matrix) on
  the device; only those cross to the host;
- optimisation matches the reference step for step: global-norm clipping at
  1.0 in optax's form (scale ``max_norm / max(norm, max_norm)``), weight decay
  as L2 added to the gradient, Adam(0.9, 0.999, 1e-8), class-weighted CE with
  ``sum(w·ce)/sum(w)`` normalisation or focal loss,
  ReduceLROnPlateau(factor 0.3, patience 20, relative threshold 1e-4) on the
  validation loss, early stopping after ``patience`` epochs whose validation
  loss improved by less than ``min_delta``, best model by validation loss or
  accuracy;
- ``ModelConfig.compute_dtype`` is the GEMMs' dtype only: parameters, Adam
  moments and the residual stream stay float32.

The opt-ins of the JAX package's fused trainer are options of this one
(``mmer_tpu/train/fused.py:111-193, 242-320``), each off at 0:

- ``modality_dropout``: one uniform draw ``u`` a row; ``u < rate/2`` zeroes
  the audio, ``rate/2 <= u < rate`` the video;
- ``mixup_alpha``: one ``λ ~ Beta(α, α)`` a step and an in-batch partner
  permutation ``j``; features and soft targets are mixed, the padding mask is
  ``mask & mask[j]`` and the loss is ``λ·L(y) + (1−λ)·L(y[j])``.  Sentinel
  rows of the tail batch can be partners, as in the JAX step;
- ``distill_alpha`` (with ``soft_targets=``): the loss is
  ``(1−α)·L + α·soft_cross_entropy(logits, soft, T)``;
- ``ema_decay``: a per-step average of the parameters, from a copy of the
  initial ones; evaluation, the scheduler's and early stopping's validation
  loss and best-model selection all see it, ``best_params`` are its weights
  and ``final_params`` the raw ones.

They refuse a batchnorm model and ``checkpoint_every``, as the JAX package
does.  Every random draw goes through one small function
(:func:`epoch_permutation`, :func:`modality_uniforms`,
:func:`partner_permutation`, :func:`mixup_lambdas`): per step ``u`` then ``j``
then the dropout masks, from the dropout generator on the run's device; the
epoch's ``λ`` from a host ``numpy`` generator seeded with the run's seed
(torch has no Beta sampler that takes a generator, and a host scalar a step
would sync).  With every opt-in at 0 nothing more is drawn.

``train_model(mesh_cfg=)`` runs data- and tensor-parallel over the ranks of a
``torch.distributed`` world (``core/mesh.py``), with JAX's sharded semantics
(``mmer_tpu/train/loop.py:457-566``, ``train/fused.py:63-110``): the dataset
is replicated and each rank gathers its rows of the global minibatch; every
draw is made for the global batch from the same seed on every rank and
sliced (dropout masks at full width, ``models/fusion.py:shard_dropout_masks``;
mixup partners gathered by global index); each rank divides its share of a
loss by the global batch's denominator, so the gradient all-reduce is a plain
sum; clipping follows the reduction, with sharded tensors' squared norms
summed over the model axis; evaluation is batch-sharded with its sums
all-reduced; rank 0 alone writes the run's files, in the single-device
layout.  On one rank the sharded step reproduces the single-device one bit
for bit.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from datetime import datetime
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from mmer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from mmer_tpu_torch.core.mesh import SINGLE, Mesh, create_mesh
from mmer_tpu_torch.data.pipeline import DataSplits, DatasetArrays
from mmer_tpu_torch.models.fusion import (DropoutMasks, MultimodalEmotionModel,
                                          draw_dropout_masks, dropout_shapes,
                                          init_fusion, shard_dropout_masks)
from mmer_tpu_torch.models.layers import param_generator
from mmer_tpu_torch.ops.losses import (focal_loss, loss_denominator,
                                       soft_cross_entropy,
                                       weighted_cross_entropy)
from mmer_tpu_torch.parallel.sharding import (gather_optimizer_state,
                                              gather_params, shard_params,
                                              slice_optimizer_state,
                                              slice_params)
from mmer_tpu_torch.train import checkpoint as ckpt
from mmer_tpu_torch.train.metrics import (accuracy_from_confusion,
                                          confusion_matrix, prf_from_confusion)


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam(0.9, 0.999, 1e-8) with the weight decay added to the gradient
    (L2, not decoupled).  :func:`clip_by_global_norm` runs before its step."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)


def clip_by_global_norm(params, max_norm: float,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale every gradient by
    ``max_norm / max(norm, max_norm)`` (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` instead).  In place, without a host sync;
    returns the norm.  On a model axis the norm is the full model's: the
    squared norms of sharded tensors (``tp_dim``) summed over the model
    group, replicated ones counted once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if mesh is None or mesh.mp == 1:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        def sq(split: bool) -> torch.Tensor:
            gs = [p.grad for p in params
                  if (getattr(p, "tp_dim", None) is not None) == split]
            return (torch.stack(torch._foreach_norm(gs)) ** 2).sum()

        norm = torch.sqrt(sq(False) + mesh.all_reduce(sq(True), "model"))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class PlateauScheduler:
    """torch ``ReduceLROnPlateau(mode='min', factor, patience)`` semantics
    with the default relative threshold 1e-4 (reference train2.py:526) and
    torch's ``eps=1e-8`` rule: a reduction smaller than eps is skipped."""

    def __init__(self, factor: float, patience: int, threshold: float = 1e-4,
                 eps: float = 1e-8):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.eps = eps
        self.best = float("inf")
        self.num_bad = 0

    def step(self, value: float, lr: float) -> float:
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            new_lr = lr * self.factor
            if lr - new_lr > self.eps:
                return new_lr
        return lr


class EpochControl:
    """The host side of an epoch's end, shared by :func:`train_model` and
    the seed-batched trainer: the plateau scheduler on the validation loss,
    best-model tracking (val loss, train2.py:617-620, or val accuracy,
    train.py:334-338) and early stopping after ``patience`` epochs whose
    validation loss improved by less than ``min_delta`` (train2.py:622-633)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.scheduler = PlateauScheduler(cfg.scheduler_factor,
                                          cfg.scheduler_patience)
        self.lr = cfg.lr
        self.best_score = float("inf")
        self.best_epoch = 0
        self.no_improve = 0
        self.prev_val_loss = float("inf")
        self.stopped = False

    def end_epoch(self, epoch: int, val_loss: float, val_acc: float) -> bool:
        """Epoch ``epoch`` (1-based) is over; True when it is the new best.
        Updates ``lr`` and sets ``stopped`` when early stopping ends the
        run."""
        self.lr = self.scheduler.step(val_loss, self.lr)
        score = val_loss if self.cfg.best_metric == "val_loss" else -val_acc
        is_best = score < self.best_score
        if is_best:
            self.best_score, self.best_epoch = score, epoch
        if self.prev_val_loss - val_loss < self.cfg.min_delta:
            self.no_improve += 1
            self.stopped = self.no_improve >= self.cfg.patience
        else:
            self.no_improve = 0
        self.prev_val_loss = val_loss
        return is_best

    def state(self) -> dict:
        return {"lr": self.lr, "sched_best": self.scheduler.best,
                "sched_bad": self.scheduler.num_bad,
                "best_score": self.best_score, "best_epoch": self.best_epoch,
                "no_improve": self.no_improve,
                "prev_val_loss": self.prev_val_loss}

    def load(self, loop: dict) -> None:
        self.lr = loop["lr"]
        self.scheduler.best = loop["sched_best"]
        self.scheduler.num_bad = loop["sched_bad"]
        self.best_score = loop["best_score"]
        self.best_epoch = loop["best_epoch"]
        self.no_improve = loop["no_improve"]
        self.prev_val_loss = loop["prev_val_loss"]


def _loss_fn(cfg: TrainConfig) -> Callable:
    """``loss(logits, labels, class_weights, sample_weight, den=None)``;
    ``den`` replaces the batch's own denominator
    (:func:`~mmer_tpu_torch.ops.losses.loss_denominator`)."""
    if cfg.loss == "weighted_ce":
        return lambda logits, labels, cw, sw, den=None: weighted_cross_entropy(
            logits, labels, cw, sw, label_smoothing=cfg.label_smoothing,
            denominator=den)
    if cfg.loss == "focal":
        return lambda logits, labels, cw, sw, den=None: focal_loss(
            logits, labels, gamma=cfg.focal_gamma, alpha=None, sample_weight=sw,
            denominator=den)
    raise ValueError(f"unknown loss {cfg.loss}")


def _pad_batches(idx: torch.Tensor, batch: int) -> torch.Tensor:
    """Pad an index vector with −1 sentinels and reshape to (steps, batch)."""
    n = idx.shape[0]
    steps = -(-n // batch)
    pad = idx.new_full((steps * batch - n,), -1)
    return torch.cat([idx, pad]).reshape(steps, batch)


def epoch_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """The epoch's shuffle: a permutation of ``range(n)`` from the host
    generator."""
    return torch.randperm(n, generator=generator)


def modality_uniforms(b: int, generator: Optional[torch.Generator],
                      device: torch.device) -> torch.Tensor:
    """A step's modality-dropout draws: ``b`` uniforms on the device."""
    return torch.rand(b, generator=generator, device=device)


def partner_permutation(b: int, generator: Optional[torch.Generator],
                        device: torch.device) -> torch.Tensor:
    """A step's mixup partners: a permutation of ``range(b)`` on the device."""
    return torch.randperm(b, generator=generator, device=device)


def mixup_lambdas(steps: int, alpha: float, rng: np.random.Generator
                  ) -> np.ndarray:
    """An epoch's mixup weights, one ``Beta(alpha, alpha)`` draw a step."""
    return rng.beta(alpha, alpha, size=steps)


OPT_INS = ("ema_decay", "mixup_alpha", "modality_dropout", "distill_alpha")


def check_opt_ins(model_cfg: ModelConfig, train_cfg: TrainConfig) -> None:
    """Refuse what the JAX package's fused trainer refuses
    (``mmer_tpu/train/loop.py:343-349``)."""
    on = [name for name in OPT_INS if getattr(train_cfg, name) > 0.0]
    if on and model_cfg.norm == "batchnorm":
        raise ValueError(f"{', '.join(on)} do not support batchnorm models "
                         "(the fused trainer's rule)")
    if on and train_cfg.checkpoint_every:
        raise ValueError(f"{', '.join(on)} do not support checkpoint_every: "
                         "the fused trainer takes no mid-run checkpoints")


def device_data(data: DatasetArrays, device: torch.device) -> Dict[str, torch.Tensor]:
    """The dataset as device-resident tensors (labels as int64 for gathers)."""
    def dev(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return {"video": dev(data.video), "audio": dev(data.audio),
            "pad_mask": dev(data.pad_mask), "labels": dev(data.labels, np.int64)}


def attach_soft_targets(dev_data: Dict[str, torch.Tensor],
                        train_cfg: TrainConfig, soft_targets) -> None:
    """Validate and insert ensemble-distillation teacher probs (N, C),
    row-aligned with the dataset, into a trainer's device-data dict as
    float32: required exactly when ``train_cfg.distill_alpha > 0``
    (``mmer_tpu/train/fused.py:333-350``; train/distill.py supplies them)."""
    if (soft_targets is not None) != (train_cfg.distill_alpha > 0.0):
        raise ValueError(
            "soft_targets must be supplied exactly when distill_alpha > 0 "
            f"(got soft_targets="
            f"{'set' if soft_targets is not None else 'None'}, "
            f"distill_alpha={train_cfg.distill_alpha})")
    if soft_targets is not None:
        n = dev_data["labels"].shape[0]
        if soft_targets.shape[0] != n:
            raise ValueError(f"soft_targets rows {soft_targets.shape[0]} "
                             f"!= dataset rows {n}")
        dev_data["soft_targets"] = torch.from_numpy(
            np.array(soft_targets, np.float32)).to(dev_data["labels"].device)


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> dict:
    """A minibatch gathered on the device: −1 sentinels read sample 0 under
    a sample weight of 0."""
    safe = idx.clamp_min(0)
    batch = {"video": data["video"][safe], "audio": data["audio"][safe],
             "mask": data["pad_mask"][safe], "labels": data["labels"][safe],
             "sw": (idx >= 0).float()}
    if "soft_targets" in data:
        batch["soft"] = data["soft_targets"][safe]
    return batch


class StepDraws(NamedTuple):
    u: Optional[torch.Tensor] = None       # (B,) modality dropout
    j: Optional[torch.Tensor] = None       # (B,) mixup partners
    lam: Optional[torch.Tensor] = None     # () mixup weight


def draw_step(train_cfg: TrainConfig, b: int,
              generator: Optional[torch.Generator], device: torch.device,
              lam: Optional[torch.Tensor] = None) -> StepDraws:
    """A step's opt-in draws, ``u`` then ``j``; nothing when both are off."""
    u = (modality_uniforms(b, generator, device)
         if train_cfg.modality_dropout > 0.0 else None)
    j = (partner_permutation(b, generator, device)
         if train_cfg.mixup_alpha > 0.0 else None)
    return StepDraws(u, j, lam)


def augmented_loss(logits_of: Callable, batch: dict, draws: StepDraws,
                   class_weights: torch.Tensor, train_cfg: TrainConfig,
                   loss_fn: Callable, partner: Optional[dict] = None,
                   dens: Optional[dict] = None) -> torch.Tensor:
    """The training loss of one gathered batch with the opt-ins applied, as
    ``mmer_tpu/train/fused.py:130-178`` computes it: modality dropout, then
    mixup, then ``logits_of(video, audio, mask)``, the hard loss and the
    distillation blend.

    The trainer's ``batch`` is a mesh rank's rows of the global batch
    (:func:`sharded_batch`; all of it on one device): ``partner`` holds its
    rows' mixup partners, gathered by global index, with their own
    modality-dropout uniforms (``"u"``), and ``dens`` the global batch's
    denominators of the hard, mixed and soft terms (``"hard"``, ``"mix"``,
    ``"soft"``).  The seed-batched trainer passes neither: its partners are
    ``batch`` rows ``draws.j`` and each term divides by its own batch's
    sum."""
    dens = dens or {}
    rate = train_cfg.modality_dropout

    def drop(rows, u):
        video, audio = rows["video"], rows["audio"]
        if rate > 0.0:
            audio = audio * (u >= rate / 2.0).to(audio.dtype)[:, None]
            video = video * ((u < rate / 2.0) | (u >= rate)).to(
                video.dtype)[:, None, None]
        return video, audio

    video, audio = drop(batch, draws.u)
    mask, labels, sw, soft = (batch["mask"], batch["labels"], batch["sw"],
                              batch.get("soft"))
    mixup = train_cfg.mixup_alpha > 0.0
    if mixup:
        lam, j = draws.lam, draws.j
        if partner is None:
            p_video, p_audio, p_mask = video[j], audio[j], mask[j]
            labels_b, p_soft = labels[j], None if soft is None else soft[j]
        else:
            p_video, p_audio = drop(partner, partner["u"])
            p_mask, labels_b, p_soft = (partner["mask"], partner["labels"],
                                        partner.get("soft"))
        video = lam * video + (1.0 - lam) * p_video
        audio = lam * audio + (1.0 - lam) * p_audio
        # True = padded: a mixed position is real if either parent's is.
        mask = mask & p_mask
        if soft is not None:
            soft = lam * soft + (1.0 - lam) * p_soft
    logits = logits_of(video, audio, mask)
    loss = loss_fn(logits, labels, class_weights, sw, dens.get("hard"))
    if mixup:
        loss = lam * loss + (1.0 - lam) * loss_fn(logits, labels_b,
                                                  class_weights, sw,
                                                  dens.get("mix"))
    alpha = train_cfg.distill_alpha
    if alpha > 0.0:
        kd = soft_cross_entropy(logits, soft, train_cfg.distill_temp, sw,
                                dens.get("soft"))
        loss = (1.0 - alpha) * loss + alpha * kd
    return loss


def sharded_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor,
                  draws: StepDraws, rows: slice, class_weights: torch.Tensor,
                  train_cfg: TrainConfig):
    """A mesh rank's part of the global minibatch ``idx`` (``rows``; the
    whole batch on one device): (its rows, its rows' draws, their mixup
    partners or None, the global denominators), as :func:`augmented_loss`
    takes them.  Labels and sample weights of the whole batch are gathered
    for the denominators, features only for the rank's rows and their
    partners."""
    safe = idx.clamp_min(0)
    labels, sw = data["labels"][safe], (idx >= 0).float()
    dens = {"hard": loss_denominator(train_cfg.loss, labels, class_weights, sw),
            "soft": loss_denominator("soft", labels, None, sw)}
    local = gather_batch(data, idx[rows])
    u = None if draws.u is None else draws.u[rows]
    partner = None
    if draws.j is not None:
        j = draws.j[rows]
        partner = gather_batch(data, idx[j])
        partner["u"] = None if draws.u is None else draws.u[j]
        dens["mix"] = loss_denominator(train_cfg.loss, labels[draws.j],
                                       class_weights, sw)
    return local, StepDraws(u, draws.j, draws.lam), partner, dens


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """``ema = decay·ema + (1 − decay)·params``, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


def train_step(model: MultimodalEmotionModel, optimizer: torch.optim.Optimizer,
               data: Dict[str, torch.Tensor], idx: torch.Tensor,
               draws: StepDraws, class_weights: torch.Tensor,
               train_cfg: TrainConfig, *,
               dropout_generator: Optional[torch.Generator] = None,
               ema: Optional[List[torch.Tensor]] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One optimizer step on the minibatch ``idx`` (−1 sentinels pad it)
    with the step's opt-in ``draws``: the loss, its gradient (all-reduced
    over the ``mesh``'s data axis), clipping, the Adam step and the EMA
    update.  Returns this rank's share of the loss, detached.  ``idx`` is
    the global minibatch (``mesh=None``: one device holds all of it); the
    dropout masks are drawn for it at full width from ``dropout_generator``
    before this rank takes its part, so every rank applies the
    single-device step's masks."""
    mesh = mesh or SINGLE
    loss_fn = _loss_fn(train_cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    b, t = idx.shape[0], data["video"].shape[1]
    rows = mesh.batch_rows(b)
    masks = draw_dropout_masks(
        model.cfg, b, t, dropout_generator,
        [torch.empty(shape, device=idx.device)
         for shape, _ in dropout_shapes(model.cfg, b, t)])
    local = DropoutMasks(shard_dropout_masks(model.cfg, masks, rows, mesh))
    batch, local_draws, partner, dens = sharded_batch(
        data, idx, draws, rows, class_weights, train_cfg)
    loss = augmented_loss(
        lambda v, a, m: model(v, a, m, generator=local)[1],
        batch, local_draws, class_weights, train_cfg, loss_fn, partner, dens)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_tensors([p.grad for p in params if p.grad is not None])
    clip_by_global_norm(params, train_cfg.clip_norm, mesh)
    optimizer.step()
    if ema is not None:
        ema_update(ema, params, train_cfg.ema_decay)
    return loss.detach()


def train_epoch(model: MultimodalEmotionModel, optimizer: torch.optim.Optimizer,
                data: Dict[str, torch.Tensor], train_idx: torch.Tensor,
                class_weights: torch.Tensor, train_cfg: TrainConfig,
                batch_size: int, *, shuffle_generator: torch.Generator,
                dropout_generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None,
                mixup_rng: Optional[np.random.Generator] = None,
                ema: Optional[List[torch.Tensor]] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One epoch over ``train_idx`` in minibatches gathered on the device;
    returns the mean of the per-step losses as a device scalar (no host sync
    inside).  ``perm`` (a permutation of ``range(len(train_idx))``) replaces
    the shuffle drawn from ``shuffle_generator``.  ``mixup_rng`` draws the
    epoch's mixup weights; ``ema`` (tensors shaped as the model's
    parameters) is updated after every optimizer step.  ``batch_size`` is
    the global batch and this rank trains on its rows of it
    (:func:`train_step`); the returned loss is the global batch's."""
    device = train_idx.device
    if perm is None:
        perm = epoch_permutation(train_idx.shape[0], shuffle_generator)
    perm = torch.as_tensor(perm, dtype=torch.long).to(device)
    batches = _pad_batches(train_idx[perm], batch_size)
    lams = None
    if train_cfg.mixup_alpha > 0.0:
        lams = torch.as_tensor(mixup_lambdas(
            len(batches), train_cfg.mixup_alpha, mixup_rng),
            dtype=torch.float32).to(device)

    model.train()
    losses = []
    for step, idx in enumerate(batches):
        draws = draw_step(train_cfg, batch_size, dropout_generator, device,
                          None if lams is None else lams[step])
        losses.append(train_step(model, optimizer, data, idx, draws,
                                 class_weights, train_cfg,
                                 dropout_generator=dropout_generator, ema=ema,
                                 mesh=mesh))
    model.eval()
    return (mesh or SINGLE).all_reduce(torch.stack(losses)).mean()


@torch.no_grad()
def evaluate(model: MultimodalEmotionModel, data: Dict[str, torch.Tensor],
             idx: torch.Tensor, class_weights: torch.Tensor,
             train_cfg: TrainConfig, num_classes: int,
             eval_batch: int = 1024, mesh: Optional[Mesh] = None):
    """A whole split → (mean of the per-batch losses weighted by batch size,
    (C, C) confusion matrix), both on the device.  Each batch is split over
    the ``mesh``'s data ranks (unevenly where it must be; one device takes
    all of it), a rank's share of a batch loss is divided by the whole
    batch's denominator, and the sums are all-reduced: every rank gets the
    split's numbers."""
    mesh = mesh or SINGLE
    loss_fn = _loss_fn(train_cfg)
    model.eval()
    loss_sum = torch.zeros((), device=idx.device)
    count = 0
    cm = torch.zeros(num_classes, num_classes, device=idx.device)
    for b in idx.split(eval_batch):
        n = len(b)
        den = loss_denominator(train_cfg.loss, data["labels"][b], class_weights)
        d = mesh.data_index
        b = b[d * n // mesh.dp:(d + 1) * n // mesh.dp]
        count += n
        if len(b) == 0:
            continue
        labels = data["labels"][b]
        _, logits, _ = model(data["video"][b], data["audio"][b],
                             data["pad_mask"][b])
        loss_sum = loss_sum + loss_fn(logits, labels, class_weights, None,
                                      den) * n
        cm = cm + confusion_matrix(labels, logits.argmax(dim=-1), num_classes)
    mesh.all_reduce_tensors([loss_sum, cm])
    return loss_sum / max(count, 1), cm


def results_row(epoch: int, train_loss: float, val_loss: float,
                val_cm: np.ndarray, test_cm: Optional[np.ndarray]) -> dict:
    """One epoch's row of the reference's results schema
    (train2.py:679-714): P/R/F1 from the confusion matrices on the host."""
    val_prf = prf_from_confusion(val_cm)
    row = {
        "epoch": epoch,
        "train_loss": train_loss,
        "val_loss": val_loss,
        "val_acc": 100.0 * accuracy_from_confusion(val_cm),
        "val_macro_precision": val_prf["macro_precision"],
        "val_macro_recall": val_prf["macro_recall"],
        "val_macro_f1": val_prf["macro_f1"],
        "val_micro_precision": val_prf["micro_precision"],
        "val_micro_recall": val_prf["micro_recall"],
        "val_micro_f1": val_prf["micro_f1"],
    }
    if test_cm is not None:
        test_prf = prf_from_confusion(test_cm)
        row.update({
            "test_acc": 100.0 * accuracy_from_confusion(test_cm),
            "test_macro_precision": test_prf["macro_precision"],
            "test_macro_recall": test_prf["macro_recall"],
            "test_macro_f1": test_prf["macro_f1"],
            "test_micro_precision": test_prf["micro_precision"],
            "test_micro_recall": test_prf["micro_recall"],
            "test_micro_f1": test_prf["micro_f1"],
        })
    return row


def _build_hyperparameters(model_cfg: ModelConfig, train_cfg: TrainConfig,
                           batch_size: int, device: torch.device,
                           mesh: dict) -> dict:
    """Run-log hyperparameters with the reference's key set
    (train2.py:748-764) and the JAX trainer's ``"mesh"``
    (``mmer_tpu/train/loop.py:410, 566``)."""
    return {
        "num_epochs": train_cfg.num_epochs, "lr": train_cfg.lr,
        "weight_decay": train_cfg.weight_decay,
        "patience": train_cfg.patience, "batch_size": batch_size,
        "device": device.type,
        "video_dim": model_cfg.video_dim, "audio_dim": model_cfg.audio_dim,
        "fused_dim": model_cfg.fused_dim,
        "num_classes": model_cfg.num_classes,
        "max_seq_len": model_cfg.max_seq_len,
        "fusion_dropout": model_cfg.fusion_dropout,
        "classifier_dropout": model_cfg.classifier_dropout,
        "num_layers": model_cfg.fusion_layers,
        "num_heads": model_cfg.fusion_heads,
        "scheduler_factor": train_cfg.scheduler_factor,
        "scheduler_patience": train_cfg.scheduler_patience,
        "focal_gamma": train_cfg.focal_gamma, "loss": train_cfg.loss,
        **({"ema_decay": train_cfg.ema_decay} if train_cfg.ema_decay > 0.0
           else {}),
        "mesh": mesh,
    }


def _save_run_artifacts(data: DatasetArrays, train_cfg: TrainConfig,
                        batch_size: int, results: list, best_epoch: int,
                        hyperparameters: dict, confusion, best_state,
                        final_state, verbose: bool):
    """Results JSON + best/final ``.pth`` state dicts + norm stats, with the
    reference's naming scheme (train2.py:748-774)."""
    if not train_cfg.save_checkpoints:
        return None, None, None, None
    os.makedirs(train_cfg.output_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    stem = f"bs{batch_size}_ep{train_cfg.num_epochs}_lr{train_cfg.lr}_{ts}"
    results_path = os.path.join(train_cfg.output_dir, f"results_{stem}.json")
    with open(results_path, "w") as f:
        json.dump({
            "training_progress": results,
            "best_model": {"epoch": best_epoch},
            "hyperparameters": hyperparameters,
            "confusion_matrix": confusion.astype(int).tolist()
            if confusion is not None else None,
        }, f, indent=4)
    best_path = None
    if best_state is not None:
        best_path = os.path.join(train_cfg.output_dir, f"best_model_{stem}.pth")
        ckpt.save_state_dict(best_path, best_state)
    final_path = os.path.join(train_cfg.output_dir, f"final_model_{stem}.pth")
    ckpt.save_state_dict(final_path, final_state)
    stats_path = ckpt.save_norm_stats(data, train_cfg.output_dir, stem)
    if verbose:
        print(f"Training results saved to {results_path}")
    return results_path, best_path, final_path, stats_path


@dataclasses.dataclass
class TrainOutput:
    best_params: Optional[Dict[str, torch.Tensor]]   # state dicts (with the
    final_params: Dict[str, torch.Tensor]            # batchnorm buffers)
    results: List[dict]
    best_epoch: int
    # The validation LOSS at the best epoch, whatever the selection metric.
    best_val_loss: float
    results_path: Optional[str]
    best_model_path: Optional[str]
    final_model_path: Optional[str]
    hyperparameters: dict
    confusion: Optional[np.ndarray] = None
    norm_stats_path: Optional[str] = None
    # The tracked selection score: val loss (best_metric="val_loss") or
    # negated val accuracy (best_metric="val_acc").
    best_score: float = float("inf")
    # Host seconds of each epoch's training pass alone (its evaluations and
    # the first epoch's library warm-up are in ``train_wall_seconds``).
    train_epoch_seconds: List[float] = dataclasses.field(default_factory=list)


def _clone_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_model(data: DatasetArrays, splits: DataSplits,
                model_cfg: ModelConfig, train_cfg: TrainConfig,
                batch_size: int = 64, seed: int = 0, verbose: bool = True,
                resume_dir: Optional[str] = None,
                device: torch.device | str = "cuda",
                initial_state: Optional[Dict[str, torch.Tensor]] = None,
                soft_targets: Optional[np.ndarray] = None,
                mesh_cfg: Optional[MeshConfig] = None) -> TrainOutput:
    """Full training run with reference-equivalent control flow and the
    reference's JSON results schema (train2.py:748-764).

    ``device`` defaults to the GPU and raises when CUDA is unavailable (pass
    ``"cpu"`` to train there).  ``initial_state`` (a state dict of the model)
    replaces the seeded initial weights.  ``resume_dir`` continues from the
    newest checkpoint that ``train_cfg.checkpoint_every`` wrote there.
    ``soft_targets`` (N, C), row-aligned with ``data``, are the teacher's
    probabilities: given exactly when ``train_cfg.distill_alpha > 0`` and
    read at training rows only.

    ``mesh_cfg`` trains over the (data, model) mesh it describes
    (:func:`~mmer_tpu_torch.core.mesh.create_mesh`): every rank of the
    process group calls ``train_model`` with the same arguments, its own
    ``device`` and the global ``batch_size`` (a multiple of the data axis).
    Every rank returns the same rows and the full (gathered) state dicts;
    rank 0 alone writes the files.  Without a process group, or with
    ``mesh_cfg=None``, the run is the single-device one.  A mid-run
    checkpoint holds the single-device layout whatever the mesh (rank 0
    writes the gathered weights and Adam moments; every rank reads it and
    takes its shard), so it resumes on any mesh, one device included, as
    JAX's do (``mmer_tpu/train/loop.py:528-560``, ``:647-660``).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_model: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    check_opt_ins(model_cfg, train_cfg)
    mesh = SINGLE if mesh_cfg is None else create_mesh(mesh_cfg)
    mesh.check_device(device)
    if batch_size % mesh.dp:
        raise ValueError(f"batch_size {batch_size} does not split over "
                         f"{mesh.dp} data ranks")
    verbose = verbose and mesh.rank == 0

    model = init_fusion(model_cfg, device=device, seed=seed)
    if initial_state is not None:
        model.load_state_dict(initial_state)
    latest = ckpt.latest_checkpoint(resume_dir) if resume_dir else None
    restored = ckpt.restore_loop_checkpoint(latest, device) if latest else None
    if restored is not None:
        # The checkpoint's single-device layout, before the model is split.
        model.load_state_dict(restored.payload["model"])
    shard_params(model, mesh)
    optimizer = make_optimizer(model, train_cfg)
    shuffle_gen = torch.Generator().manual_seed(seed)
    dropout_gen = param_generator(seed + 1, device)
    mixup_rng = np.random.default_rng(seed)

    dev_data = device_data(data, device)
    attach_soft_targets(dev_data, train_cfg, soft_targets)
    class_weights = torch.from_numpy(
        np.array(splits.class_weights, np.float32)).to(device)
    train_idx, val_idx, test_idx = (
        torch.from_numpy(np.array(s, np.int64)).to(device)
        for s in (splits.train, splits.val, splits.test))

    control = EpochControl(train_cfg)
    results: List[dict] = []
    best_state = None

    start_epoch = 0
    if restored is not None:
        optimizer.load_state_dict(slice_optimizer_state(
            restored.payload["optimizer"], model, mesh))
        shuffle_gen.set_state(restored.payload["shuffle_rng"].cpu())
        dropout_gen.set_state(restored.payload["dropout_rng"].cpu())
        start_epoch = restored.step
        control.load(restored.loop)
        if restored.loop["has_best"]:
            best_state = slice_params(restored.payload["best"], mesh)
        set_learning_rate(optimizer, control.lr)
        if verbose:
            print(f"Resumed from {latest} at epoch {start_epoch}")

    # With EMA on, a second model holds the average (from the weights the
    # run starts from) and is what is evaluated.
    ema_model = copy.deepcopy(model) if train_cfg.ema_decay > 0.0 else None
    eval_model = ema_model or model
    hyperparameters = _build_hyperparameters(model_cfg, train_cfg, batch_size,
                                             device, mesh.shape)
    num_classes = model_cfg.num_classes

    def eval_split(idx):
        loss_d, cm_d = evaluate(eval_model, dev_data, idx, class_weights,
                                train_cfg, num_classes, mesh=mesh)
        return float(loss_d), cm_d.cpu().numpy()

    t_start = time.time()
    train_epoch_seconds: List[float] = []
    for epoch in range(start_epoch, train_cfg.num_epochs):
        t_epoch = time.perf_counter()
        # float() is the training pass's one host sync.
        train_loss = float(train_epoch(model, optimizer, dev_data, train_idx,
                                       class_weights, train_cfg, batch_size,
                                       shuffle_generator=shuffle_gen,
                                       dropout_generator=dropout_gen,
                                       mixup_rng=mixup_rng,
                                       ema=None if ema_model is None else
                                       list(ema_model.parameters()),
                                       mesh=mesh))
        train_epoch_seconds.append(time.perf_counter() - t_epoch)
        val_loss, val_cm = eval_split(val_idx)
        val_acc = 100.0 * accuracy_from_confusion(val_cm)

        if control.end_epoch(epoch + 1, val_loss, val_acc):
            # A real copy, parameters and batchnorm statistics together: the
            # live tensors are updated in place by the next epoch.
            best_state = _clone_state(eval_model)
        set_learning_rate(optimizer, control.lr)

        test_cm = (eval_split(test_idx)[1] if train_cfg.eval_test_every_epoch
                   else None)
        row = results_row(epoch + 1, train_loss, val_loss, val_cm, test_cm)
        results.append(row)

        if verbose and (epoch % train_cfg.log_every == 0):
            msg = (f"Epoch {epoch + 1}/{train_cfg.num_epochs}, "
                   f"Train Loss: {row['train_loss']:.4f}, "
                   f"Val Loss: {val_loss:.4f}, Val Acc: {val_acc:.2f}%")
            if "test_acc" in row:
                msg += (f", Test Acc: {row['test_acc']:.2f}%, "
                        f"Test Macro F1: {row['test_macro_f1']:.4f}")
            print(msg, flush=True)

        if control.stopped:
            if verbose:
                print(f"Early stopping at epoch {epoch + 1}")
            break

        # Periodic full-state checkpoint, taken after this epoch's updates so
        # that a resumed run continues the interrupted one exactly.  Every
        # rank gathers (the collectives are the model group's), rank 0
        # writes, and no rank goes on before the file is complete.  The
        # generators' states are the same on every rank.
        if (train_cfg.checkpoint_every
                and (epoch + 1) % train_cfg.checkpoint_every == 0):
            model_state = gather_params(model.state_dict(), mesh)
            payload = {
                "model": model_state,
                "optimizer": gather_optimizer_state(optimizer.state_dict(),
                                                    model, mesh),
                "best": (model_state if best_state is None
                         else gather_params(best_state, mesh)),
                "shuffle_rng": shuffle_gen.get_state(),
                "dropout_rng": dropout_gen.get_state()}
            if mesh.rank == 0:
                ckpt.save_loop_checkpoint(
                    os.path.join(train_cfg.output_dir, "checkpoints"),
                    epoch + 1, payload,
                    {**control.state(), "has_best": best_state is not None})
            mesh.barrier()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    hyperparameters["train_wall_seconds"] = time.time() - t_start

    # Best-model confusion matrix on test (train2.py:719-743).
    final_state = _clone_state(model)
    confusion = None
    if best_state is not None:
        held = _clone_state(eval_model)
        eval_model.load_state_dict(best_state)
        _, confusion = eval_split(test_idx)
        eval_model.load_state_dict(held)
        if verbose:
            print("Confusion matrix (rows = true, cols = pred):")
            print(confusion.astype(int))

    best_epoch, best_score = control.best_epoch, control.best_score
    # A model axis's shards, gathered into the single-device layout.
    final_state = gather_params(final_state, mesh)
    if best_state is not None:
        best_state = gather_params(best_state, mesh)
    results_path = best_path = final_path = stats_path = None
    if mesh.rank == 0:
        results_path, best_path, final_path, stats_path = _save_run_artifacts(
            data, train_cfg, batch_size, results, best_epoch, hyperparameters,
            confusion, best_state, final_state, verbose)

    # On a resumed run the best epoch may predate the resume point; with
    # val-loss selection the tracked best_score is that epoch's val loss.
    best_val_loss = next(
        (r["val_loss"] for r in results if r["epoch"] == best_epoch),
        float(best_score) if train_cfg.best_metric == "val_loss"
        else float("inf"))
    return TrainOutput(
        best_params=best_state, final_params=final_state, results=results,
        best_epoch=best_epoch, best_val_loss=best_val_loss,
        best_score=best_score, results_path=results_path,
        best_model_path=best_path, final_model_path=final_path,
        hyperparameters=hyperparameters, confusion=confusion,
        norm_stats_path=stats_path, train_epoch_seconds=train_epoch_seconds)
