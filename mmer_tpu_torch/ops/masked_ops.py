"""Mask-aware sequence ops shared by the fusion model and the extractors
(the port of ``mmer_tpu/ops/masked_ops.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def masked_mean_pool(x: torch.Tensor,
                     pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over sequence positions (axis 1), ignoring padded ones.

    ``pad_mask``: (B, S) bool, True = padded.  The count is clamped at
    1e-6, as in the reference.
    """
    if pad_mask is None:
        return x.mean(dim=1)
    keep = (~pad_mask).to(x.dtype).unsqueeze(-1)           # (B, S, 1)
    total = (x * keep).sum(dim=1)
    count = keep.sum(dim=1).clamp_min(1e-6)
    return total / count


def attention_bias_from_pad_mask(pad_mask: Optional[torch.Tensor]
                                 ) -> Optional[torch.Tensor]:
    """(B, S) True-for-pad mask → (B, 1, 1, S) additive bias: the float32
    minimum on padded keys, 0 elsewhere."""
    if pad_mask is None:
        return None
    neg = torch.finfo(torch.float32).min
    bias = torch.zeros(pad_mask.shape, device=pad_mask.device)
    return bias.masked_fill(pad_mask, neg)[:, None, None, :]
