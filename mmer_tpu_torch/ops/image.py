"""Batched bbox crop + bilinear resize on the frames' device, the port of
``mmer_tpu/ops/image.py``.

Bilinear resize as two products: ``resize(I) = R_h · I · R_wᵀ``, where
``R_h`` (out_h, H) and ``R_w`` (out_w, W) hold the interpolation weights,
built from each frame's runtime bbox with pixel-centre sampling
(``align_corners=False``) and rows normalised to sum to 1 at clipped
borders.  The JAX package computes this outside any Pallas kernel, as two
einsums; here they are two batched f32 ``matmul`` calls.  The products run
with TF32 off: the crops are truncated to uint8 afterwards, and TF32's
10-bit mantissa moves values across integer boundaries.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _axis_weights(start: torch.Tensor, stop: torch.Tensor, out_size: int,
                  in_size: int) -> torch.Tensor:
    """(N, out_size, in_size) bilinear sampling matrices for the half-open
    crop windows ``[start, stop)`` (each (N,) float32) of an axis of length
    ``in_size``."""
    dev = start.device
    span = torch.clamp(stop - start, min=1.0)
    # The sampling positions round as the JAX function's compiled form
    # rounds them: the step is span · f32(1/out_size), and t · step + start
    # is rounded once (a fused multiply-add, exact here in float64).  A
    # position one f32 ulp off moves a crop pixel by up to 255 of them.
    recip = torch.tensor(1.0 / out_size, dtype=torch.float32, device=dev)
    scale = span * recip
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)[None, None, :]
    src = (start.double()[:, None, None]
           + (out_idx + 0.5).double() * scale.double()[:, None, None]
           ).float() - 0.5
    d = torch.abs(in_idx - torch.clamp(src, 0.0, in_size - 1.0))
    w = torch.clamp(1.0 - d, min=0.0)
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-6)


def crop_resize_batch(frames: torch.Tensor, bboxes: torch.Tensor,
                      out_hw: Tuple[int, int] = (224, 224)) -> torch.Tensor:
    """Crop each frame to its bbox and bilinearly resize to ``out_hw``.

    frames: (N, H, W, C) float32 or uint8; bboxes: (N, 4) as (x1, y1, x2,
    y2) in pixels, on the frames' device.  Returns (N, out_h, out_w, C)
    float32 on that device."""
    frames = frames.float()
    bboxes = bboxes.to(device=frames.device, dtype=torch.float32)
    out_h, out_w = out_hw
    n, h, w, c = frames.shape
    rh = _axis_weights(bboxes[:, 1], bboxes[:, 3], out_h, h)     # (N, oh, H)
    rw = _axis_weights(bboxes[:, 0], bboxes[:, 2], out_w, w)     # (N, ow, W)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (N, oh, H) @ (N, H, W·C) over H, then (N, ow, W) over W.
        tmp = torch.bmm(rh, frames.reshape(n, h, w * c)).reshape(n, out_h, w, c)
        tmp = tmp.permute(0, 2, 1, 3).reshape(n, w, out_h * c)
        out = torch.bmm(rw, tmp).reshape(n, out_w, out_h, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.permute(0, 2, 1, 3).contiguous()


def resize_batch(frames: torch.Tensor,
                 out_hw: Tuple[int, int] = (224, 224)) -> torch.Tensor:
    """Full-frame batched bilinear resize to ``out_hw``."""
    n, h, w, _ = frames.shape
    full = torch.tensor([0.0, 0.0, float(w), float(h)], dtype=torch.float32,
                        device=frames.device).repeat(n, 1)
    return crop_resize_batch(frames, full, out_hw)
