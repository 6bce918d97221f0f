"""Fused transformer-block kernels, the port of ``mmer_tpu/ops/fused_blocks.py``.

:func:`fused_ffn` computes ``x + GELU(LN(x) W1ᵀ + b1) W2ᵀ + b2`` with the
``(tokens, M)`` hidden tensor never written to device memory: on a CUDA
tensor it launches the hand-written kernel ``csrc/ffn.cu`` (the port of the
Pallas ``_ffn_kernel``); on a CPU tensor it runs :func:`ffn_reference`, the
plain PyTorch version of the same arithmetic.

Numerics follow the Pallas kernel: LayerNorm in float32 with flax semantics
(:func:`layer_norm`), GEMMs on the weights' dtype with float32 accumulation,
bias and exact-erf GELU in float32, residual in float32, output in ``x``'s
dtype.  Weights use the ``nn.Linear`` layout, ``w1 (M, D)`` and
``w2 (D, M)``; the JAX function takes their transposes.

:func:`fused_ln_matmul` computes ``LN(x) Wᵀ`` with the LayerNorm output never
written to device memory (``csrc/ln_matmul.cu``, the port of the Pallas
``_ln_matmul_kernel``; plain version :func:`ln_matmul_reference`).  No model
routes through it, as in the JAX package: the profile script
(``scripts/profile_fused_blocks.py``) times it against LayerNorm + a matmul.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mmer_tpu_torch.ops import _build

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """``flax.linen.LayerNorm(dtype=float32)`` over the last axis: float32
    math, ``var = max(0, E[x²] − E[x]²)``, eps 1e-6 (torch's default is
    1e-5).  Returns float32."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ffn` (same arguments)."""
    y = layer_norm(x, ln_w, ln_b).to(w1.dtype)
    h = torch.matmul(y.float(), w1.float().t()) + b1.float()
    h = F.gelu(h).to(w2.dtype)
    out = x.float() + torch.matmul(h.float(), w2.float().t()) + b2.float()
    return out.to(x.dtype)


# mmer_fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2, out, n_tok, d, m, x_is_f32,
#                stream)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_ffn(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``x + GELU(LN(x) @ w1ᵀ + b1) @ w2ᵀ + b2`` — the whole pre-norm FFN
    sublayer.

    x: (..., D) bfloat16 or float32; ln_w, ln_b: (D,) float32;
    w1: (M, D), w2: (D, M) in the compute dtype; b1: (M,), b2: (D,) in any
    float dtype (added in float32).  Returns x's shape and dtype.

    On CUDA the kernel takes bf16 weights, D in {768, 1024} and M a
    multiple of 128, and raises on anything else.
    """
    if x.device.type == "cpu":
        return ffn_reference(x, ln_w, ln_b, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    d = x.shape[-1]
    m = w1.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_ffn: x must be bf16 or f32, got {x.dtype}")
    if w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise TypeError("fused_ffn: the CUDA kernel takes bf16 weights")
    if d not in (768, 1024) or m % 128:
        raise ValueError(f"fused_ffn: kernel needs D in (768, 1024) and M % 128 "
                         f"== 0, got D={d}, M={m}")
    if tuple(w1.shape) != (m, d) or tuple(w2.shape) != (d, m):
        raise ValueError(f"fused_ffn: weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit D={d}")
    vecs = [t.float().contiguous() for t in (ln_w, ln_b, b1, b2)]
    if [t.numel() for t in vecs] != [d, d, m, d]:
        raise ValueError("fused_ffn: LN params and biases must be (D,), (D,), "
                         "(M,), (D,)")
    for t in (x, w1, w2, *vecs):
        if t.device != x.device:
            raise ValueError("fused_ffn: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("fused_ffn: tensors must be contiguous")
    out = torch.empty_like(x)
    _build.call(
        "ffn", "mmer_fused_ffn", _ARGTYPES,
        _build.ptr(x), _build.ptr(vecs[0]), _build.ptr(vecs[1]), _build.ptr(w1),
        _build.ptr(vecs[2]), _build.ptr(w2), _build.ptr(vecs[3]), _build.ptr(out),
        x.numel() // d, d, m, int(x.dtype == torch.float32),
        _build.stream_ptr(x.device))
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


def ln_matmul_reference(x, ln_w, ln_b, w) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_matmul` (same arguments)."""
    y = layer_norm(x, ln_w, ln_b).to(w.dtype)
    return torch.matmul(y.float(), w.float().t()).to(w.dtype)


# mmer_fused_ln_matmul(x, ln_w, ln_b, w, out, n_tok, d, n, x_is_f32, stream)
_ARGTYPES_LN_MATMUL = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_ln_matmul(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``LayerNorm(x) @ wᵀ``: float32 LayerNorm (:func:`layer_norm`) rounded
    to ``w``'s dtype, the product accumulated in float32 and rounded once.

    x: (..., D) bfloat16 or float32; ln_w, ln_b: (D,) float32; w: (N, D) in
    the compute dtype, the ``nn.Linear`` layout (the JAX function takes the
    transpose, (D, N)).  Returns (..., N) in **w's** dtype.

    On CUDA the kernel takes a bf16 weight, D in {768, 1024} and N a multiple
    of 64, and raises on anything else.
    """
    if x.device.type == "cpu":
        return ln_matmul_reference(x, ln_w, ln_b, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_matmul: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_ln_matmul: x must be bf16 or f32, got {x.dtype}")
    if w.dtype != torch.bfloat16:
        raise TypeError("fused_ln_matmul: the CUDA kernel takes a bf16 weight")
    if w.dim() != 2 or w.shape[1] != d:
        raise ValueError(f"fused_ln_matmul: weight shape {tuple(w.shape)} does "
                         f"not fit D={d}")
    n = w.shape[0]
    if d not in (768, 1024) or n % 64:
        raise ValueError(f"fused_ln_matmul: kernel needs D in (768, 1024) and "
                         f"N % 64 == 0, got D={d}, N={n}")
    vecs = [t.float().contiguous() for t in (ln_w, ln_b)]
    if [t.numel() for t in vecs] != [d, d]:
        raise ValueError("fused_ln_matmul: LN params must be (D,), (D,)")
    for t in (x, w, *vecs):
        if t.device != x.device:
            raise ValueError("fused_ln_matmul: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("fused_ln_matmul: tensors must be contiguous")
    out = torch.empty(*x.shape[:-1], n, dtype=w.dtype, device=x.device)
    _build.call(
        "ln_matmul", "mmer_fused_ln_matmul", _ARGTYPES_LN_MATMUL,
        _build.ptr(x), _build.ptr(vecs[0]), _build.ptr(vecs[1]), _build.ptr(w),
        _build.ptr(out), x.numel() // d, d, n, int(x.dtype == torch.float32),
        _build.stream_ptr(x.device))
    fused_ln_matmul.launches += 1
    return out


fused_ln_matmul.launches = 0
