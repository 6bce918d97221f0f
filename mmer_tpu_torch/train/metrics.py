"""Classification metrics from an on-device confusion matrix, the port of
``mmer_tpu/train/metrics.py``.

The evaluation accumulates a (C, C) confusion matrix on the device; only
those C² numbers cross to the host, where macro / micro precision, recall
and F1 are derived from the matrix.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     num_classes: int,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(C, C) float32 confusion matrix, rows = true, cols = predicted, as a
    product of one-hot matrices; ``sample_weight`` weighs the rows."""
    classes = torch.arange(num_classes, device=labels.device)
    oh_true = (labels[:, None] == classes[None, :]).float()
    oh_pred = (preds[:, None] == classes[None, :]).float()
    if sample_weight is not None:
        oh_true = oh_true * sample_weight[:, None]
    return oh_true.t() @ oh_pred


def accuracy_from_confusion(cm: np.ndarray) -> float:
    total = cm.sum()
    return float(np.trace(cm) / total) if total > 0 else 0.0


def _safe_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # zero_division=0 semantics (the reference passes it to sklearn)
    out = np.zeros_like(a, dtype=np.float64)
    nz = b != 0
    out[nz] = a[nz] / b[nz]
    return out


def prf_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """Macro and micro precision / recall / F1 from a confusion matrix: what
    sklearn's ``precision_recall_fscore_support`` returns for
    average='macro' / 'micro' with zero_division=0."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    pred_pos = cm.sum(axis=0)
    true_pos = cm.sum(axis=1)

    prec = _safe_div(tp, pred_pos)
    rec = _safe_div(tp, true_pos)
    f1 = _safe_div(2 * prec * rec, prec + rec)

    micro_p = micro_r = micro_f = (
        float(tp.sum() / cm.sum()) if cm.sum() > 0 else 0.0)
    return {
        "macro_precision": float(prec.mean()),
        "macro_recall": float(rec.mean()),
        "macro_f1": float(f1.mean()),
        "micro_precision": micro_p,
        "micro_recall": micro_r,
        "micro_f1": micro_f,
    }
