"""Ensemble distillation's teacher targets, the port of
``mmer_tpu/train/distill.py``.

A seed/recipe ensemble is compressed into one fusion model: a student is
trained against the ensemble's mean probabilities
(``train_model(..., soft_targets=...)`` with ``distill_alpha > 0``, or
``train_many_seeds``), keeping most of the blend's quality at one model's
serving cost.  Member selection and the student's best epoch use the
validation split only; the trainer reads the soft targets at training rows
only (the other rows are there for row alignment).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig
from mmer_tpu_torch.train.ensemble import member_models
from mmer_tpu_torch.train.fused import stacked_probs


def teacher_soft_targets(model_cfg: ModelConfig,
                         params_list: Sequence[dict], data,
                         batch: int = 512,
                         device: torch.device | str = "cuda") -> np.ndarray:
    """Mean softmax probabilities of the members ``params_list`` (state
    dicts) over the whole dataset, as a host ``(N, C)`` float32 array
    row-aligned with ``data``: the trainer's ``soft_targets``.  The members
    run as one stacked forward a batch of ``batch`` rows; probabilities,
    not logits, are averaged, as serving blends members."""
    if not params_list:
        raise ValueError("need at least one teacher member")
    members = member_models(model_cfg, params_list, device)
    n = int(data.labels.shape[0])
    total = np.zeros((n, model_cfg.num_classes), np.float32)
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(device)

        probs = stacked_probs(members, dev(data.video).float(),
                              dev(data.audio).float(), dev(data.pad_mask))
        for p in probs.cpu().numpy():          # the members in order
            total[lo:hi] += p
    return total / len(params_list)
