"""Fused multi-head attention, the port of ``mmer_tpu/ops/flash_attention.py``.

:func:`flash_attention` computes non-causal ``softmax(q kᵀ/√d) v`` over
``(B, H, S, D)`` tensors without materialising the ``(S, S)`` score matrix
in device memory.  On a CUDA tensor it launches an online-softmax kernel of
``csrc/attention.cu``: the port of the Pallas ``_attn_kernel`` (ViViT, no
``key_lens``), or of ``_attn_kernel_varlen`` when ``key_lens`` gives one key
length per batch element (Wav2Vec2: clips shorter than the padded batch
attend to their own frames only).  On a CPU tensor it runs the plain version,
:func:`reference_attention` or :func:`reference_attention_varlen`.

:func:`tiled_attention_reference` repeats the kernel's order of operations
(key tiles, online max and sum, the mask on edge tiles only, tiles past a
clip's length skipped) in plain PyTorch, so that the design is held against
the plain versions and the JAX kernel where there is no GPU.

Each kernel has its own wrapper and launch count: :func:`flash_attention`
counts launches of the unmasked kernel, :func:`flash_attention_varlen` of the
key-length kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mmer_tpu_torch.ops import _build

KEY_BIAS = -1e9   # finite, so a fully masked row softmaxes to uniform, not NaN
HEAD_DIM = 64     # the head dim csrc/attention.cu takes


def attention_limits(head_dim: int) -> str | None:
    """The limit of the CUDA attention kernels that a head dim breaks, as a
    sentence naming it; None if it breaks none."""
    if head_dim != HEAD_DIM:
        return f"the attention kernel takes head dim {HEAD_DIM}, got {head_dim}"
    return None


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain attention over (B, H, S, D): f32 scores and softmax, the
    probabilities rounded to v's dtype for the second product, output in
    q's dtype — the JAX ``reference_attention``."""
    return reference_attention_varlen(q, k, v, None)


def reference_attention_varlen(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               key_lens: torch.Tensor | None) -> torch.Tensor:
    """Plain version of :func:`flash_attention` with ``key_lens``: f32
    scores, an additive −1e9 on keys at or beyond each batch element's
    length, f32 softmax, the probabilities rounded to v's dtype, output in
    q's dtype — the JAX ``EncoderLayer._xla_attention`` with a suffix pad
    mask.  A row whose length is 0 comes out as the mean of all S values."""
    d, s = q.shape[-1], q.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if key_lens is not None:
        lens = key_lens.to(q.device).reshape(q.shape[0], 1, 1, 1)
        masked = torch.arange(s, device=q.device) >= lens          # (B,1,1,S)
        scores = scores + masked.float() * KEY_BIAS
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


KEY_TILE = 64     # keys per tile of csrc/attention.cu


def tiled_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_lens: torch.Tensor | None = None,
                              key_tile: int = KEY_TILE) -> torch.Tensor:
    """The CUDA kernel's order of operations over (B, H, S, D), in plain
    PyTorch.  Keys are visited in tiles of ``key_tile``; per tile the f32
    scores update a running row max ``m`` (from −inf) and the output and
    denominator so far are rescaled by ``alpha = exp(m_old − m_new)``;
    ``p = exp(score − m_new)`` is rounded to v's dtype before ``p · v`` and
    the denominator is summed **from the rounded p**; the output is divided
    once at the end.  The mask touches only the tiles that need it: in the
    ragged last tile keys at or beyond S do not take part, and with
    ``key_lens`` the tile that holds a clip's length gets the finite −1e9 on
    keys in ``[len, S)``; tiles wholly past ``len`` are skipped (their keys
    would have probability exactly 0), except for ``len == 0``, where every
    tile is visited with the bias on every key (the uniform mean over S)."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for bi in range(b):
        n = s if key_lens is None else max(0, min(int(key_lens[bi]), s))
        kend = n if n > 0 else s
        qf = q[bi].float()
        m_run = torch.full((h, s, 1), float("-inf"))
        l_run = torch.zeros(h, s, 1)
        o = torch.zeros(h, s, d)
        for k0 in range(0, kend, key_tile):
            k1 = min(k0 + key_tile, s)          # keys >= S are -inf: absent
            sc = torch.matmul(qf, k[bi, :, k0:k1].float().transpose(-1, -2)) * scale
            if key_lens is not None and k0 + key_tile > n:      # the tile of len
                sc = sc + (torch.arange(k0, k1) >= n).float() * KEY_BIAS
            m_new = torch.maximum(m_run, sc.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(sc - m_new).to(v.dtype).float()
            l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.matmul(p, v[bi, :, k0:k1].float())
            m_run = m_new
        out[bi] = (o / l_run).to(q.dtype)
    return out


def _check_qkv(name: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, H, S, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    limit = attention_limits(q.shape[-1])
    if limit:
        raise ValueError(f"{name}: {limit}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel takes bf16, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: q, k, v must be contiguous on one device")


# mmer_attention(q, k, v, out, bh, s, d, scale, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                          ctypes.c_void_p]
# mmer_attention_varlen(q, k, v, out, lens, b, h, s, d, scale, stream)
_ARGTYPES_VARLEN = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over (B, H, S, D) tensors; returns (B, H, S, D) in q's
    dtype.  Without ``key_lens`` keys are unmasked over the true S (no
    padding is visible to the caller); with it see
    :func:`flash_attention_varlen`.  On CUDA the kernels take contiguous
    bf16 with D = 64."""
    if key_lens is not None:
        return flash_attention_varlen(q, k, v, key_lens)
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    _check_qkv("flash_attention", q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    _build.call("attention", "mmer_attention", _ARGTYPES,
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                b * h, s, d, 1.0 / math.sqrt(d), _build.stream_ptr(q.device))
    flash_attention.launches += 1
    return out


def flash_attention_varlen(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_lens: torch.Tensor) -> torch.Tensor:
    """Attention over (B, H, S, D) where batch element b attends to its
    first ``key_lens[b]`` keys: ``key_lens`` is ``(B,)`` integer, clamped to
    S; keys at or beyond it carry a finite −1e9 additive bias (exact zero
    probability next to any valid key; a length of 0 gives the uniform
    average over the S values, never NaN)."""
    if key_lens.dim() != 1 or key_lens.shape[0] != q.shape[0] \
            or key_lens.dtype.is_floating_point:
        raise ValueError(f"flash_attention: key_lens must be (B,) integer, got "
                         f"{tuple(key_lens.shape)} {key_lens.dtype}")
    if q.device.type == "cpu":
        return reference_attention_varlen(q, k, v, key_lens)
    _check_qkv("flash_attention", q, k, v)
    b, h, s, d = q.shape
    lens = key_lens.to(device=q.device, dtype=torch.int32).clamp(max=s).contiguous()
    out = torch.empty_like(q)
    _build.call("attention", "mmer_attention_varlen", _ARGTYPES_VARLEN,
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                _build.ptr(lens), b, h, s, d, 1.0 / math.sqrt(d),
                _build.stream_ptr(q.device))
    flash_attention_varlen.launches += 1
    return out


flash_attention.launches = 0
flash_attention_varlen.launches = 0
