"""Wav2Vec2's positional-conv sublayer as one CUDA kernel.

:func:`pos_conv_residual` computes the sublayer of
``Wav2Vec2Encoder.encode_frames`` between the feature projection and the
first transformer layer:

    xm  = x with the padded frames zeroed
    out = xm + GELU(bf16(bf16(conv(bf16(xm), W)) + bf16(b)))

with ``conv`` the grouped convolution of ``num_conv_pos_embeddings`` taps in
``num_conv_pos_embedding_groups`` groups, zero padding of half the taps, the
trailing frame of an even kernel dropped (flax's and Hugging Face's), and
the exact-erf GELU rounded once to bf16 (ROADMAP C4).  ``x`` and ``out`` are
(B, T, D) float32: the residual stream stays float32.

On a CUDA tensor it launches ``csrc/pos_conv.cu`` once; on a CPU tensor it
runs :func:`pos_conv_reference`, the plain PyTorch version (the sublayer as
the encoder computed it before the kernel, cuDNN's grouped ``F.conv1d``
where it runs on the card).  The JAX package has no Pallas kernel here: XLA
compiles its ``nn.Conv(feature_group_count=16)``
(``mmer_tpu/models/wav2vec2.py:185``).

On CUDA the kernel takes a bf16 compute dtype, groups of 64 channels and at
most MAX_TAPS taps: :func:`pos_conv_limits` names the first of these a
config breaks.  Its grid comes from :func:`pos_conv_plan`, a function of
the shape and the card alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mmer_tpu_torch.config import compute_dtype_limit, torch_dtype
from mmer_tpu_torch.ops import _build
from mmer_tpu_torch.ops.fused_blocks import _sm_count
from mmer_tpu_torch.utils.profiling import cast

# csrc/pos_conv.cu: channels a group (the wgmma M of the output channels and
# the K of one tap), the most taps its window in shared memory takes, and the
# frames a block computes (two warpgroups of 128 or 64 frames).
GROUP_WIDTH = 64
MAX_TAPS = 128
TILES = (256, 128)


def pos_conv_limits(cfg) -> str | None:
    """The first limit of the CUDA positional-conv kernel that ``cfg``
    breaks, as a sentence naming it; None if it breaks none."""
    dtype_limit = compute_dtype_limit(cfg)
    if dtype_limit:
        return dtype_limit
    d, groups = cfg.hidden_dim, cfg.num_conv_pos_embedding_groups
    if d % groups or d // groups != GROUP_WIDTH:
        return (f"the positional-conv kernel takes groups of {GROUP_WIDTH} "
                f"channels, got {d} channels in {groups} groups")
    taps = cfg.num_conv_pos_embeddings
    if not 1 <= taps <= MAX_TAPS:
        return (f"the positional-conv kernel takes at most {MAX_TAPS} taps, "
                f"got {taps}")
    return None


def pos_conv_plan(batch: int, frames: int, groups: int, taps: int,
                  sm_count: int) -> tuple[int, int]:
    """``(tile, blocks)`` of the kernel's grid for ``batch`` rows of
    ``frames`` frames in ``groups`` channel groups and ``taps`` taps: a block
    for each ``tile`` frames of each group of each row.  Of the tiles whose
    grid puts a block on every SM, the one whose blocks stage the fewest
    window rows (each its tile and the ``taps - 1`` frames around it: the
    padding a short last tile computes, and the halo and the weight slice
    that every tile reads again), the taller on a tie; where none fills the
    card, the shortest.  A function of the shape and the card alone."""
    if batch < 1 or frames < 1 or groups < 1 or taps < 1 or sm_count < 1:
        raise ValueError(f"pos_conv_plan: batch={batch}, frames={frames}, "
                         f"groups={groups}, taps={taps}, sm_count={sm_count}")
    best = None
    for tile in TILES:
        tiles = -(-frames // tile)
        blocks = batch * groups * tiles
        rows = tiles * (tile + taps - 1)
        if blocks >= sm_count and (best is None or rows < best[2]):
            best = (tile, blocks, rows)
    if best is None:
        tile = TILES[-1]
        return tile, batch * groups * -(-frames // tile)
    return best[0], best[1]


def pos_conv_reference(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                       weight: torch.Tensor, bias: torch.Tensor,
                       cfg) -> torch.Tensor:
    """Plain PyTorch version of :func:`pos_conv_residual` (same arguments),
    in ``cfg``'s compute dtype: the padded frames zeroed, the conv of the
    operands in that dtype with float32 sums, rounded, the bias added in that
    dtype (as flax's Conv does), the trailing frame of an even kernel
    dropped, GELU in float32 rounded once, the residual in float32."""
    dt = torch_dtype(cfg)
    if pad_mask is not None:
        x = x.masked_fill(pad_mask[:, :, None], 0.0)
    taps = cfg.num_conv_pos_embeddings
    xt = x.to(dt).transpose(1, 2)
    w, b = cast(weight, dt), cast(bias, dt)
    if xt.device.type == "cpu" and dt == torch.bfloat16:
        # PyTorch's CPU bf16 grouped conv1d returns wrong values (rel-L2
        # ~1 against the f32 conv of the same operands, torch 2.13).  The
        # same rounding points: bf16 operands, f32 sums, bf16 output.
        xt, w = xt.float(), w.float()
    y = F.conv1d(xt, w, padding=taps // 2,
                 groups=cfg.num_conv_pos_embedding_groups).to(dt) + b[:, None]
    if taps % 2 == 0:
        y = y[:, :, :-1]
    return x + F.gelu(y).transpose(1, 2).float()


def kernel_weight(weight: torch.Tensor) -> torch.Tensor:
    """Conv1d weight (D, 64, k) float32 → the kernel's layout in bf16:
    (groups, k, 64 output channels, 64 input channels), so that one tap of
    one group is a contiguous (64, 64) tile."""
    d, width, taps = weight.shape
    w = cast(weight, torch.bfloat16).view(d // width, width, width, taps)
    return w.permute(0, 3, 1, 2).contiguous()


# mmer_pos_conv_gelu(x, mask, w, bias, out, batch, t_len, d, taps, tile, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def pos_conv_residual(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                      weight: torch.Tensor, bias: torch.Tensor,
                      cfg) -> torch.Tensor:
    """The positional-conv sublayer (module docstring) over ``x`` (B, T, D)
    float32; ``pad_mask`` (B, T) bool, True on padded frames, or None;
    ``weight`` (D, D / groups, k) and ``bias`` (D,), the float32 params of
    the ``nn.Conv1d``.  Returns (B, T, D) float32.

    On CUDA the kernel takes what :func:`pos_conv_limits` allows and raises
    on anything else; the weight is cast to bf16 in its layout on every call
    (:func:`kernel_weight`).  ``pos_conv_residual.last_plan`` holds the plan
    of the latest launch (:func:`pos_conv_plan`)."""
    if x.device.type == "cpu":
        return pos_conv_reference(x, pad_mask, weight, bias, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"pos_conv_residual: unsupported device {x.device}")
    limit = pos_conv_limits(cfg)
    if limit:
        raise ValueError(f"pos_conv_residual: {limit}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise TypeError("pos_conv_residual: the CUDA kernel takes a contiguous "
                        f"(B, T, D) float32 stream, got {x.dtype} "
                        f"{tuple(x.shape)}")
    bsz, t_len, d = x.shape
    groups, taps = cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    if d != cfg.hidden_dim or tuple(weight.shape) != (d, d // groups, taps) \
            or tuple(bias.shape) != (d,):
        raise ValueError(f"pos_conv_residual: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)} do "
                         f"not fit D={cfg.hidden_dim}, {groups} groups, {taps} taps")
    if pad_mask is not None and (pad_mask.dtype != torch.bool
                                 or tuple(pad_mask.shape) != (bsz, t_len)):
        raise ValueError(f"pos_conv_residual: pad_mask must be (B, T) bool, got "
                         f"{pad_mask.dtype} {tuple(pad_mask.shape)}")
    wk = kernel_weight(weight)
    bk = cast(bias, torch.bfloat16).contiguous()
    mask = None if pad_mask is None else pad_mask.contiguous()
    for t in (wk, bk) + (() if mask is None else (mask,)):
        if t.device != x.device:
            raise ValueError("pos_conv_residual: all tensors must be on one device")
    plan = pos_conv_plan(bsz, t_len, groups, taps, _sm_count(x.device))
    out = torch.empty_like(x)
    _build.call("pos_conv", "mmer_pos_conv_gelu", _ARGTYPES,
                _build.ptr(x), None if mask is None else _build.ptr(mask),
                _build.ptr(wk), _build.ptr(bk), _build.ptr(out),
                bsz, t_len, d, taps, plan[0], _build.stream_ptr(x.device))
    pos_conv_residual.launches += 1
    pos_conv_residual.last_plan = plan
    return out


pos_conv_residual.launches = 0
pos_conv_residual.last_plan = None
