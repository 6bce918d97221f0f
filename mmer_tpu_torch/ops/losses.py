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
batch contribute nothing to the loss or its gradient, and a ``denominator``
that replaces the batch's own normaliser.  :func:`loss_denominator` is the
one rule for that normaliser: each loss divides by it, and a data-parallel
rank passes the global batch's, so that the ranks' losses sum to the global
batch's loss.  All math in float32.
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


def ce_weights(labels: torch.Tensor,
               class_weights: Optional[torch.Tensor] = None,
               sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-row weights of :func:`weighted_cross_entropy`, whose sum is
    its denominator."""
    w = torch.ones_like(labels, dtype=torch.float32) if class_weights is None \
        else class_weights.float()[labels.long()]
    return w if sample_weight is None else w * sample_weight


def loss_denominator(kind: str, labels: torch.Tensor,
                     class_weights: Optional[torch.Tensor] = None,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """What the loss ``kind`` divides a batch's summed per-row losses by:
    the sum of its real rows' class weights (``"weighted_ce"``,
    :func:`ce_weights`), the count of its real rows (``"focal"``, ``"soft"``;
    these read only the row count of ``labels``).  A data-parallel rank
    computes it from the global batch, whose labels every rank holds."""
    if kind == "weighted_ce":
        return ce_weights(labels, class_weights, sample_weight).sum()
    if kind not in ("focal", "soft"):
        raise ValueError(f"unknown loss {kind}")
    if sample_weight is not None:
        return sample_weight.sum()
    return torch.tensor(float(labels.shape[0]), device=labels.device)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           sample_weight: Optional[torch.Tensor] = None,
                           label_smoothing: float = 0.0,
                           denominator: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    ce = _per_sample_ce(logits, labels, label_smoothing)
    w = ce_weights(labels, class_weights, sample_weight)
    if denominator is None:
        denominator = loss_denominator("weighted_ce", labels, class_weights,
                                       sample_weight)
    return (w * ce).sum() / denominator.clamp_min(1e-12)


def _weighted_mean(kind: str, per: torch.Tensor,
                   sample_weight: Optional[torch.Tensor],
                   denominator: Optional[torch.Tensor]) -> torch.Tensor:
    num = per.sum() if sample_weight is None else (per * sample_weight).sum()
    if denominator is None:
        denominator = loss_denominator(kind, per, None, sample_weight)
    return num / denominator.clamp_min(1e-12)


def soft_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor,
                       temperature: float = 1.0,
                       sample_weight: Optional[torch.Tensor] = None,
                       denominator: Optional[torch.Tensor] = None
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
    return _weighted_mean("soft", per, sample_weight, denominator)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[torch.Tensor] = None,
               sample_weight: Optional[torch.Tensor] = None,
               denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    ce = _per_sample_ce(logits, labels)
    pt = torch.exp(-ce)
    fl = (1.0 - pt) ** gamma * ce
    if alpha is not None:
        fl = alpha.float()[labels.long()] * fl
    return _weighted_mean("focal", fl, sample_weight, denominator)
