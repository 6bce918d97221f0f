"""Classification losses, the port of ``mmer_tpu/ops/losses.py``.

- :func:`weighted_cross_entropy` is ``torch.nn.CrossEntropyLoss(weight=w)``
  (the v2 criterion, reference train2.py:523): per-sample loss
  ``-w[y] * log_softmax(logits)[y]``, normalised by ``sum(w[y])`` over the
  batch, not by the batch size.
- :func:`focal_loss` is the reference ``FocalLoss`` (train2.py:40-70, the v1
  criterion): ``(1 - pt)^gamma * ce`` with optional per-class alpha, plain
  mean.
- :func:`soft_cross_entropy` is the distillation loss (cross-entropy to a
  soft target distribution at a temperature).

Each takes a 0/1 ``sample_weight`` so that sentinel-padded rows of a tail
batch contribute nothing to the loss or its gradient.  All math in float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def _per_sample_ce(logits: torch.Tensor, labels: torch.Tensor,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        # torch CrossEntropyLoss(label_smoothing=eps) semantics.
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           sample_weight: Optional[torch.Tensor] = None,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    ce = _per_sample_ce(logits, labels, label_smoothing)
    w = torch.ones_like(ce) if class_weights is None \
        else class_weights.float()[labels.long()]
    if sample_weight is not None:
        w = w * sample_weight
    return (w * ce).sum() / w.sum().clamp_min(1e-12)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor,
                       temperature: float = 1.0,
                       sample_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``-sum_c q_T[c] * log_softmax(logits / T)[c]``, scaled by ``T**2`` and
    averaged over the ``sample_weight``-real rows.  The teacher arrives as
    probabilities; at T != 1 it is sharpened as
    ``q_T = softmax(log(q) / T)``."""
    t = float(temperature)
    q = target_probs.float()
    if t != 1.0:
        q = torch.softmax(torch.log(q.clamp_min(1e-12)) / t, dim=-1)
    logp = torch.log_softmax(logits.float() / t, dim=-1)
    per = -(q * logp).sum(dim=-1) * (t * t)
    if sample_weight is None:
        return per.mean()
    return (per * sample_weight).sum() / sample_weight.sum().clamp_min(1e-12)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[torch.Tensor] = None,
               sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    ce = _per_sample_ce(logits, labels)
    pt = torch.exp(-ce)
    fl = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        fl = alpha.float()[labels.long()] * fl
    if sample_weight is not None:
        return (fl * sample_weight).sum() / sample_weight.sum().clamp_min(1e-12)
    return fl.mean()
