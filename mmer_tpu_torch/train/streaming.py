"""Streaming trainer: a disk-to-device batch stream for feature sets larger
than device memory, the port of ``mmer_tpu/train/streaming.py``.

The JAX module's semantics, driven by ``data/streaming.py``'s prefetched
batches: Adam with global-norm clipping and L2 weight decay
(``train/loop.py``), the class-weighted CE with the batch's sample weights
(whatever ``train_cfg.loss`` says, as in JAX),
the plateau scheduler on the validation loss, early stopping, and the best
parameters by validation loss.  The initial weights are JAX's for
``PRNGKey(seed)`` itself (JAX's streaming trainer inits with the unsplit
key, ``train_model`` with its split), and so are the dropout masks: the
key of the run's global step ``i`` is ``fold_in(PRNGKey(seed), i)``
(``train/keys.py``, the "streaming" schedule), so a run reproduces JAX's
``train_streaming`` of the same seed.

Use it when the features do not fit in device memory; otherwise
``train_model`` is faster.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig, TrainConfig
from mmer_tpu_torch.data.streaming import StreamingFeatureDataset
from mmer_tpu_torch.models import jax_init
from mmer_tpu_torch.models.fusion import DropoutMasks, init_fusion
from mmer_tpu_torch.ops.losses import weighted_cross_entropy
from mmer_tpu_torch.train.keys import KeySchedule
from mmer_tpu_torch.train.loop import (PlateauScheduler, clip_by_global_norm,
                                       make_optimizer, set_learning_rate)


def train_streaming(train_ds: StreamingFeatureDataset,
                    val_ds: StreamingFeatureDataset,
                    model_cfg: ModelConfig, train_cfg: TrainConfig,
                    class_weights: np.ndarray, seed: int = 0,
                    verbose: bool = True,
                    device: torch.device | str = "cuda") -> Dict:
    """→ ``{"params", "best_params", "results"}``: the final and best state
    dicts and one row a epoch (``epoch``, ``train_loss``, ``val_loss``,
    ``val_acc``, ``learning_rate``).  Runs on the GPU unless ``device`` says
    otherwise; raises without CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_streaming: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    model = init_fusion(model_cfg, device=device, seed=seed,
                        key=jax_init.PRNGKey(seed))
    optimizer = make_optimizer(model, train_cfg)
    params = list(model.parameters())
    cw = torch.as_tensor(np.asarray(class_weights, np.float32), device=device)
    keys = KeySchedule([seed], "streaming", model_cfg, train_cfg,
                       train_ds.batch_size, train_ds.max_chunks, device)

    scheduler = PlateauScheduler(train_cfg.scheduler_factor,
                                 train_cfg.scheduler_patience)
    lr = train_cfg.lr
    best_val = float("inf")
    best_params = None
    prev_val = float("inf")
    no_improve = 0
    results: List[Dict] = []

    for epoch in range(train_cfg.num_epochs):
        model.train()
        losses = []
        for batch in train_ds.epoch(epoch, device=device):
            rand = keys.draw()
            _, logits, _ = model(batch["video"], batch["audio"],
                                 batch["pad_mask"],
                                 masks=DropoutMasks(rand.masks, rand.scales))
            loss = weighted_cross_entropy(logits, batch["labels"].long(), cw,
                                          batch["weight"])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm(params, train_cfg.clip_norm)
            optimizer.step()
            losses.append(loss.detach())
        model.eval()
        train_loss = float(torch.stack(losses).mean())

        loss_sum = correct = weight_sum = torch.zeros((), device=device)
        with torch.no_grad():
            for batch in val_ds.epoch(0, device=device):       # a fixed order
                labels, w = batch["labels"].long(), batch["weight"]
                _, logits, _ = model(batch["video"], batch["audio"],
                                     batch["pad_mask"])
                loss = weighted_cross_entropy(logits, labels, cw, w)
                loss_sum = loss_sum + loss * w.sum()
                correct = correct + ((logits.argmax(-1) == labels) * w).sum()
                weight_sum = weight_sum + w.sum()
        val_loss = float(loss_sum) / max(float(weight_sum), 1.0)
        val_acc = 100.0 * float(correct) / max(float(weight_sum), 1.0)

        lr = scheduler.step(val_loss, lr)
        set_learning_rate(optimizer, lr)
        if val_loss < best_val:
            best_val = val_loss
            best_params = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
        results.append({"epoch": epoch + 1, "train_loss": train_loss,
                        "val_loss": val_loss, "val_acc": val_acc,
                        "learning_rate": float(np.float32(lr))})
        if verbose:
            print(f"Epoch {epoch + 1}: train {train_loss:.4f} "
                  f"val {val_loss:.4f} acc {val_acc:.2f}%", flush=True)

        if prev_val - val_loss < train_cfg.min_delta:
            no_improve += 1
            if no_improve >= train_cfg.patience:
                break
        else:
            no_improve = 0
        prev_val = val_loss

    return {"params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "best_params": best_params, "results": results}
