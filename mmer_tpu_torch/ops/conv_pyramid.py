"""Wav2Vec2 conv feature encoder, the port of ``mmer_tpu/ops/conv_pyramid.py``.

:func:`fused_conv_encoder` maps a waveform (B, L) to frame features
(B, T, 512): seven VALID conv layers, each conv → bias → LayerNorm → exact-erf
GELU.  On a CUDA tensor every layer is one launch of the hand-written
kernel ``csrc/conv_encoder.cu`` (the port of the Pallas ``_mega_kernel``),
which runs the conv as a GEMM over im2col rows staged in shared memory and
applies the epilogue before anything returns to device memory; on a CPU
tensor it runs :func:`conv_encoder_reference`.

Rounding points follow the Pallas ``_epilogue``: the input is rounded to the
compute dtype, the conv output is rounded, the bias is added in the compute
dtype, LayerNorm runs in float32 and is rounded, GELU runs in float32 and
is rounded.

Conv weights use the ``nn.Conv1d`` layout ``(C_out, C_in, k)``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from mmer_tpu_torch.config import torch_dtype
from mmer_tpu_torch.ops import _build
from mmer_tpu_torch.ops.fused_blocks import layer_norm

__all__ = ["conv_encoder_reference", "fused_conv_encoder", "gemm_weight",
           "supports_config"]


def supports_config(cfg) -> bool:
    """The HF Wav2Vec2 feature-encoder family the kernels cover: layer-norm
    variant, any first layer, then stride-2 layers with kernel 2 or 3."""
    return (cfg.feat_extract_norm == "layer"
            and all(s == 2 and k in (2, 3)
                    for k, s in zip(cfg.conv_kernels[1:], cfg.conv_strides[1:])))


def gemm_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Conv1d weight (C_out, C_in, k) → the conv-as-GEMM matrix
    (C_out, k·C_in rounded up to 16), tap-major to match contiguous input
    rows, zero-padded, in ``dtype``."""
    c_out, c_in, k = weight.shape
    w = weight.permute(0, 2, 1).reshape(c_out, k * c_in)
    kp = -(-k * c_in // 16) * 16
    return F.pad(w, (0, kp - k * c_in)).to(dtype).contiguous()


def _check_args(wave, weights, cfg) -> None:
    if not supports_config(cfg):
        raise ValueError("fused_conv_encoder: unsupported conv stack "
                         f"(kernels {cfg.conv_kernels}, strides "
                         f"{cfg.conv_strides}, norm {cfg.feat_extract_norm})")
    if wave.dim() != 2:
        raise ValueError(f"fused_conv_encoder: wave must be (B, L), got "
                         f"{tuple(wave.shape)}")
    if len(weights) != len(cfg.conv_kernels):
        raise ValueError("fused_conv_encoder: one weight per conv layer")
    t = wave.shape[1]
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        t = (t - k) // s + 1
    if t < 1:
        raise ValueError(f"fused_conv_encoder: {wave.shape[1]} samples give no "
                         "output frame")


def conv_encoder_reference(wave: torch.Tensor, weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor],
                           ln_weights: Sequence[torch.Tensor],
                           ln_biases: Sequence[torch.Tensor], cfg) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_conv_encoder` (same arguments)."""
    _check_args(wave, weights, cfg)
    dt = torch_dtype(cfg)
    x = wave.to(dt).unsqueeze(-1)                          # (B, L, 1)
    for w, cb, lw, lb, k, s in zip(weights, biases, ln_weights, ln_biases,
                                   cfg.conv_kernels, cfg.conv_strides):
        b, _, c_in = x.shape
        rows = x.unfold(1, k, s).permute(0, 1, 3, 2)       # (B, T, k, C_in)
        rows = rows.reshape(b, rows.shape[1], k * c_in).float()
        wg = gemm_weight(w, dt).float()[:, :k * c_in]
        y = torch.matmul(rows, wg.t()).to(dt) + cb.to(dt)
        y = layer_norm(y, lw, lb).to(dt)
        x = F.gelu(y.float()).to(dt)
    return x


# mmer_conv_ln_gelu(x, w, cb, ln_w, ln_b, out, batch, t_in, t_out, c_in,
#                   c_out, k, stride, kp, x_is_f32, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def fused_conv_encoder(wave: torch.Tensor, weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor],
                       ln_weights: Sequence[torch.Tensor],
                       ln_biases: Sequence[torch.Tensor], cfg) -> torch.Tensor:
    """Waveform (B, L) float32 → frame features (B, T, conv_dims[-1]) in
    the compute dtype, T from ``feat_extract_output_length``.

    ``weights[i]`` is layer i's Conv1d weight (C_out, C_in, k); ``biases``,
    ``ln_weights``, ``ln_biases`` its conv bias and LayerNorm params.  On
    CUDA the kernel takes a bf16 compute dtype and 512 channels per layer.
    """
    if wave.device.type == "cpu":
        return conv_encoder_reference(wave, weights, biases, ln_weights,
                                      ln_biases, cfg)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_conv_encoder: unsupported device {wave.device}")
    _check_args(wave, weights, cfg)
    if torch_dtype(cfg) != torch.bfloat16 or wave.dtype != torch.float32:
        raise TypeError("fused_conv_encoder: the CUDA kernel takes an f32 "
                        "waveform and a bf16 compute dtype")
    stream = _build.stream_ptr(wave.device)
    x = wave.contiguous()
    bsz = x.shape[0]
    for w, cb, lw, lb, k, s in zip(weights, biases, ln_weights, ln_biases,
                                   cfg.conv_kernels, cfg.conv_strides):
        c_out, c_in = w.shape[0], w.shape[1]
        if c_out != 512 or (x.shape[2] if x.dim() == 3 else 1) != c_in:
            raise ValueError(f"fused_conv_encoder: kernel needs 512 channels "
                             f"and matching layer widths, got {tuple(w.shape)}")
        t_in = x.shape[1]
        t_out = (t_in - k) // s + 1
        wg = gemm_weight(w, torch.bfloat16)
        vecs = [t.float().contiguous() for t in (cb, lw, lb)]
        for t in (wg, *vecs):
            if t.device != x.device:
                raise ValueError("fused_conv_encoder: all tensors must be on "
                                 "one device")
        out = torch.empty((bsz, t_out, c_out), dtype=torch.bfloat16,
                          device=x.device)
        _build.call(
            "conv_encoder", "mmer_conv_ln_gelu", _ARGTYPES,
            _build.ptr(x), _build.ptr(wg), _build.ptr(vecs[0]),
            _build.ptr(vecs[1]), _build.ptr(vecs[2]), _build.ptr(out),
            bsz, t_in, t_out, c_in, c_out, k, s, wg.shape[1],
            int(x.dtype == torch.float32), stream)
        fused_conv_encoder.launches += 1
        x = out
    return x


fused_conv_encoder.launches = 0
