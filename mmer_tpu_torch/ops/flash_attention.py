"""Fused multi-head attention, the port of ``mmer_tpu/ops/flash_attention.py``.

:func:`flash_attention` computes non-causal ``softmax(q kᵀ/√d) v`` over
``(B, H, S, D)`` tensors without materialising the ``(S, S)`` score matrix
in device memory: on a CUDA tensor it launches the online-softmax kernel
``csrc/attention.cu`` (the port of the Pallas ``_attn_kernel``); on a CPU
tensor it runs :func:`reference_attention`.

Only the ``key_lens=None`` path is ported (ViViT's).  The per-batch
key-length variant (``_attn_kernel_varlen``, Wav2Vec2 attention) is off the
serving path in JAX too and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mmer_tpu_torch.ops import _build


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain attention over (B, H, S, D): f32 scores and softmax, the
    probabilities rounded to v's dtype for the second product, output in
    q's dtype — the JAX ``reference_attention``."""
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


# mmer_attention(q, k, v, out, bh, s, d, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors; returns (B, H, S, D) in q's
    dtype.  Keys are unmasked over the true S (no padding is visible to the
    caller).  On CUDA the kernel takes contiguous bf16 with D = 64."""
    if key_lens is not None:
        raise NotImplementedError(
            "flash_attention: the key_lens (varlen) kernel is not ported yet")
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, H, S, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if d != 64:
        raise ValueError(f"flash_attention: kernel needs head dim 64, got {d}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: kernel takes bf16, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous on "
                             "one device")
    out = torch.empty_like(q)
    _build.call("attention", "mmer_attention", _ARGTYPES,
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                b * h, s, d, 1.0 / math.sqrt(d), _build.stream_ptr(q.device))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
