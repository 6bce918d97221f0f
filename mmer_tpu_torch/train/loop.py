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

The opt-ins of the JAX package's fused trainer (EMA, mixup, modality dropout,
distillation) and multi-device training are not part of this trainer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from datetime import datetime
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig, TrainConfig
from mmer_tpu_torch.data.pipeline import DataSplits, DatasetArrays
from mmer_tpu_torch.models.fusion import MultimodalEmotionModel, init_fusion
from mmer_tpu_torch.models.layers import param_generator
from mmer_tpu_torch.ops.losses import focal_loss, weighted_cross_entropy
from mmer_tpu_torch.train import checkpoint as ckpt
from mmer_tpu_torch.train.metrics import (accuracy_from_confusion,
                                          confusion_matrix, prf_from_confusion)


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam(0.9, 0.999, 1e-8) with the weight decay added to the gradient
    (L2, not decoupled).  :func:`clip_by_global_norm` runs before its step."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale every gradient by
    ``max_norm / max(norm, max_norm)`` (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` instead).  In place, without a host sync;
    returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
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


def _loss_fn(cfg: TrainConfig) -> Callable:
    if cfg.loss == "weighted_ce":
        return lambda logits, labels, cw, sw: weighted_cross_entropy(
            logits, labels, cw, sw, label_smoothing=cfg.label_smoothing)
    if cfg.loss == "focal":
        return lambda logits, labels, cw, sw: focal_loss(
            logits, labels, gamma=cfg.focal_gamma, alpha=None, sample_weight=sw)
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


def device_data(data: DatasetArrays, device: torch.device) -> Dict[str, torch.Tensor]:
    """The dataset as device-resident tensors (labels as int64 for gathers)."""
    def dev(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return {"video": dev(data.video), "audio": dev(data.audio),
            "pad_mask": dev(data.pad_mask), "labels": dev(data.labels, np.int64)}


def train_epoch(model: MultimodalEmotionModel, optimizer: torch.optim.Optimizer,
                data: Dict[str, torch.Tensor], train_idx: torch.Tensor,
                class_weights: torch.Tensor, train_cfg: TrainConfig,
                batch_size: int, *, shuffle_generator: torch.Generator,
                dropout_generator: Optional[torch.Generator] = None,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One epoch over ``train_idx`` in minibatches gathered on the device;
    returns the mean of the per-step losses as a device scalar (no host sync
    inside).  ``perm`` (a permutation of ``range(len(train_idx))``) replaces
    the shuffle drawn from ``shuffle_generator``."""
    loss_fn = _loss_fn(train_cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    if perm is None:
        perm = epoch_permutation(train_idx.shape[0], shuffle_generator)
    perm = torch.as_tensor(perm, dtype=torch.long).to(train_idx.device)
    batches = _pad_batches(train_idx[perm], batch_size)
    model.train()
    losses = []
    for idx in batches:
        sw = (idx >= 0).float()
        safe = idx.clamp_min(0)
        _, logits, _ = model(data["video"][safe], data["audio"][safe],
                             data["pad_mask"][safe], generator=dropout_generator)
        loss = loss_fn(logits, data["labels"][safe], class_weights, sw)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm(params, train_cfg.clip_norm)
        optimizer.step()
        losses.append(loss.detach())
    model.eval()
    return torch.stack(losses).mean()


@torch.no_grad()
def evaluate(model: MultimodalEmotionModel, data: Dict[str, torch.Tensor],
             idx: torch.Tensor, class_weights: torch.Tensor,
             train_cfg: TrainConfig, num_classes: int,
             eval_batch: int = 1024):
    """A whole split → (mean of the per-batch losses weighted by batch size,
    (C, C) confusion matrix), both on the device."""
    loss_fn = _loss_fn(train_cfg)
    model.eval()
    loss_sum = torch.zeros((), device=idx.device)
    count = 0
    cm = torch.zeros(num_classes, num_classes, device=idx.device)
    for b in idx.split(eval_batch):
        labels = data["labels"][b]
        _, logits, _ = model(data["video"][b], data["audio"][b],
                             data["pad_mask"][b])
        loss_sum = loss_sum + loss_fn(logits, labels, class_weights, None) * len(b)
        count += len(b)
        cm = cm + confusion_matrix(labels, logits.argmax(dim=-1), num_classes)
    return loss_sum / max(count, 1), cm


def _build_hyperparameters(model_cfg: ModelConfig, train_cfg: TrainConfig,
                           batch_size: int, device: torch.device) -> dict:
    """Run-log hyperparameters with the reference's key set
    (train2.py:748-764)."""
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
                initial_state: Optional[Dict[str, torch.Tensor]] = None
                ) -> TrainOutput:
    """Full training run with reference-equivalent control flow and the
    reference's JSON results schema (train2.py:748-764).

    ``device`` defaults to the GPU and raises when CUDA is unavailable (pass
    ``"cpu"`` to train there).  ``initial_state`` (a state dict of the model)
    replaces the seeded initial weights.  ``resume_dir`` continues from the
    newest checkpoint that ``train_cfg.checkpoint_every`` wrote there.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_model: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    for name in ("ema_decay", "mixup_alpha", "modality_dropout", "distill_alpha"):
        if getattr(train_cfg, name) > 0.0:
            raise ValueError(f"train_model: {name} is not implemented in this "
                             "trainer")

    model = init_fusion(model_cfg, device=device,
                        generator=param_generator(seed, device))
    if initial_state is not None:
        model.load_state_dict(initial_state)
    optimizer = make_optimizer(model, train_cfg)
    shuffle_gen = torch.Generator().manual_seed(seed)
    dropout_gen = param_generator(seed + 1, device)

    dev_data = device_data(data, device)
    class_weights = torch.from_numpy(
        np.array(splits.class_weights, np.float32)).to(device)
    train_idx, val_idx, test_idx = (
        torch.from_numpy(np.array(s, np.int64)).to(device)
        for s in (splits.train, splits.val, splits.test))

    scheduler = PlateauScheduler(train_cfg.scheduler_factor,
                                 train_cfg.scheduler_patience)
    lr = train_cfg.lr
    results: List[dict] = []
    best_score = float("inf")
    best_state = None
    best_epoch = 0
    epochs_without_improvement = 0
    previous_val_loss = float("inf")

    start_epoch = 0
    if resume_dir:
        latest = ckpt.latest_checkpoint(resume_dir)
        if latest:
            restored = ckpt.restore_loop_checkpoint(latest, device)
            model.load_state_dict(restored.payload["model"])
            optimizer.load_state_dict(restored.payload["optimizer"])
            shuffle_gen.set_state(restored.payload["shuffle_rng"].cpu())
            dropout_gen.set_state(restored.payload["dropout_rng"].cpu())
            start_epoch = restored.step
            loop = restored.loop
            lr = loop["lr"]
            scheduler.best = loop["sched_best"]
            scheduler.num_bad = loop["sched_bad"]
            best_score = loop["best_score"]
            best_epoch = loop["best_epoch"]
            epochs_without_improvement = loop["no_improve"]
            previous_val_loss = loop["prev_val_loss"]
            if loop["has_best"]:
                best_state = restored.payload["best"]
            set_learning_rate(optimizer, lr)
            if verbose:
                print(f"Resumed from {latest} at epoch {start_epoch}")

    hyperparameters = _build_hyperparameters(model_cfg, train_cfg, batch_size,
                                             device)
    num_classes = model_cfg.num_classes

    def eval_split(idx):
        loss_d, cm_d = evaluate(model, dev_data, idx, class_weights, train_cfg,
                                num_classes)
        return float(loss_d), cm_d.cpu().numpy()

    t_start = time.time()
    train_epoch_seconds: List[float] = []
    for epoch in range(start_epoch, train_cfg.num_epochs):
        t_epoch = time.perf_counter()
        # float() is the training pass's one host sync.
        train_loss = float(train_epoch(model, optimizer, dev_data, train_idx,
                                       class_weights, train_cfg, batch_size,
                                       shuffle_generator=shuffle_gen,
                                       dropout_generator=dropout_gen))
        train_epoch_seconds.append(time.perf_counter() - t_epoch)
        val_loss, val_cm = eval_split(val_idx)
        val_acc = 100.0 * accuracy_from_confusion(val_cm)
        val_prf = prf_from_confusion(val_cm)

        lr = scheduler.step(val_loss, lr)
        set_learning_rate(optimizer, lr)

        # best-model selection: v2 tracks val loss (train2.py:617-620),
        # v1 tracks val accuracy (train.py:334-338).
        score = val_loss if train_cfg.best_metric == "val_loss" else -val_acc
        if score < best_score:
            best_score = score
            # A real copy, parameters and batchnorm statistics together: the
            # live tensors are updated in place by the next epoch.
            best_state = _clone_state(model)
            best_epoch = epoch + 1

        row = {
            "epoch": epoch + 1,
            "train_loss": train_loss,
            "val_loss": val_loss,
            "val_acc": val_acc,
            "val_macro_precision": val_prf["macro_precision"],
            "val_macro_recall": val_prf["macro_recall"],
            "val_macro_f1": val_prf["macro_f1"],
            "val_micro_precision": val_prf["micro_precision"],
            "val_micro_recall": val_prf["micro_recall"],
            "val_micro_f1": val_prf["micro_f1"],
        }
        if train_cfg.eval_test_every_epoch:
            _, test_cm = eval_split(test_idx)
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
        results.append(row)

        if verbose and (epoch % train_cfg.log_every == 0):
            msg = (f"Epoch {epoch + 1}/{train_cfg.num_epochs}, "
                   f"Train Loss: {row['train_loss']:.4f}, "
                   f"Val Loss: {val_loss:.4f}, Val Acc: {val_acc:.2f}%")
            if "test_acc" in row:
                msg += (f", Test Acc: {row['test_acc']:.2f}%, "
                        f"Test Macro F1: {row['test_macro_f1']:.4f}")
            print(msg, flush=True)

        # Early stopping on per-epoch improvement (train2.py:622-633).
        if previous_val_loss - val_loss < train_cfg.min_delta:
            epochs_without_improvement += 1
            if epochs_without_improvement >= train_cfg.patience:
                if verbose:
                    print(f"Early stopping at epoch {epoch + 1}")
                break
        else:
            epochs_without_improvement = 0
        previous_val_loss = val_loss

        # Periodic full-state checkpoint, taken after this epoch's updates so
        # that a resumed run continues the interrupted one exactly.
        if (train_cfg.checkpoint_every
                and (epoch + 1) % train_cfg.checkpoint_every == 0):
            ckpt.save_loop_checkpoint(
                os.path.join(train_cfg.output_dir, "checkpoints"), epoch + 1,
                {"model": model.state_dict(),
                 "optimizer": optimizer.state_dict(),
                 "best": best_state if best_state is not None
                 else model.state_dict(),
                 "shuffle_rng": shuffle_gen.get_state(),
                 "dropout_rng": dropout_gen.get_state()},
                {"lr": lr, "sched_best": scheduler.best,
                 "sched_bad": scheduler.num_bad, "best_score": best_score,
                 "best_epoch": best_epoch,
                 "no_improve": epochs_without_improvement,
                 "prev_val_loss": previous_val_loss,
                 "has_best": best_state is not None})

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    hyperparameters["train_wall_seconds"] = time.time() - t_start

    # Best-model confusion matrix on test (train2.py:719-743).
    final_state = _clone_state(model)
    confusion = None
    if best_state is not None:
        model.load_state_dict(best_state)
        _, confusion = eval_split(test_idx)
        model.load_state_dict(final_state)
        if verbose:
            print("Confusion matrix (rows = true, cols = pred):")
            print(confusion.astype(int))

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
