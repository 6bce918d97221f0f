"""Fused transformer-block kernels, the port of ``mmer_tpu/ops/fused_blocks.py``.

:func:`fused_ffn` computes ``x + GELU(LN(x) W1ᵀ + b1) W2ᵀ + b2`` with the
``(tokens, M)`` hidden tensor never written to device memory: on a CUDA
tensor it launches the hand-written kernel ``csrc/ffn.cu`` (the port of the
Pallas ``_ffn_kernel``); on a CPU tensor it runs :func:`ffn_reference`, the
plain PyTorch version of the same arithmetic.  The kernel's grid comes from
:func:`ffn_plan`, a function of the token count and the card's SM count;
:func:`ffn_split_reference` repeats, in plain PyTorch, the order in which a
plan's slices are computed and added.

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
Its grid comes from :func:`ln_matmul_plan`; :func:`ln_matmul_tiled_reference`
repeats the kernel's order of operations in plain PyTorch.

On CUDA both kernels take D in {768, 1024} and bf16 weights, the FFN an M
that is a multiple of 256, the LN-matmul an N that is a multiple of 64:
:func:`ffn_limits` and :func:`ln_matmul_limits` name the first of these a
shape breaks.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mmer_tpu_torch.ops import _build

LN_EPS = 1e-6
# The widths D the kernels of csrc/ffn.cu and csrc/ln_matmul.cu take.
KERNEL_WIDTHS = (768, 1024)


def ffn_limits(d: int, m: int) -> str | None:
    """The first limit of the CUDA FFN kernel that a (D, M) sublayer breaks,
    as a sentence naming it; None if it breaks none."""
    if d not in KERNEL_WIDTHS:
        return f"the FFN kernel takes D in {KERNEL_WIDTHS}, got D = {d}"
    if m < FFN_CHUNK or m % FFN_CHUNK:
        return f"the FFN kernel takes M a multiple of {FFN_CHUNK}, got M = {m}"
    return None


def ln_matmul_limits(d: int, n: int) -> str | None:
    """The first limit of the CUDA LN-matmul kernel that a (D, N) product
    breaks, as a sentence naming it; None if it breaks none."""
    if d not in KERNEL_WIDTHS:
        return f"the LN-matmul kernel takes D in {KERNEL_WIDTHS}, got D = {d}"
    if n < 1 or n % LN_MATMUL_COLS:
        return f"the LN-matmul kernel takes N a multiple of {LN_MATMUL_COLS}, got N = {n}"
    return None


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


# The kernel's tiling (csrc/ffn.cu): token rows a block, blocks that share a
# row tile (each owns D / 2 output columns), hidden units a chunk.
FFN_ROWS, FFN_D_SPLIT, FFN_CHUNK = 64, 2, 256
# csrc/ln_matmul.cu: token rows a block, output columns a tile of the N walk,
# K a step; N must be a multiple of LN_MATMUL_COLS.
LN_MATMUL_ROWS, LN_MATMUL_TILE, LN_MATMUL_KSTEP, LN_MATMUL_COLS = 64, 256, 64, 64


def ffn_plan(n_tok: int, d: int, m: int, sm_count: int) -> tuple[int, int, int]:
    """``(rows, d_split, m_split)`` of the kernel's grid for a call of
    ``n_tok`` tokens: ``ceil(n_tok / rows) * d_split * m_split`` blocks, each
    of ``rows`` token rows, ``d / d_split`` output columns and slice ``z`` of
    the hidden dimension, chunks ``[z * c // m_split, (z + 1) * c // m_split)``
    of ``c = m // 256``.  One slice when the row tiles alone put a block on
    every SM (the partial tiles then never leave the registers); otherwise
    enough slices to reach ``sm_count`` blocks, at most one chunk a slice.  A
    function of the shape and the card alone."""
    if n_tok < 1 or d % FFN_D_SPLIT or m < FFN_CHUNK or m % FFN_CHUNK or sm_count < 1:
        raise ValueError(f"ffn_plan: n_tok={n_tok}, d={d}, m={m}, sm_count={sm_count}")
    blocks = -(-n_tok // FFN_ROWS) * FFN_D_SPLIT
    m_split = 1 if blocks >= sm_count else min(m // FFN_CHUNK, -(-sm_count // blocks))
    return FFN_ROWS, FFN_D_SPLIT, m_split


def ffn_slices(m: int, m_split: int) -> list[tuple[int, int]]:
    """Hidden-unit ranges ``[m0, m1)`` of the ``m_split`` slices of a plan."""
    c = m // FFN_CHUNK
    return [(z * c // m_split * FFN_CHUNK, (z + 1) * c // m_split * FFN_CHUNK)
            for z in range(m_split)]


def ffn_split_reference(x, ln_w, ln_b, w1, b1, w2, b2, m_split: int,
                        d_split: int = FFN_D_SPLIT) -> torch.Tensor:
    """The kernel's order of operations for a plan with ``m_split`` slices, in
    plain PyTorch: every (D slice, M slice) pair computes
    ``GELU(LN(x) W1[m0:m1]ᵀ + b1[m0:m1]) W2[d0:d1, m0:m1]ᵀ`` with the hidden
    units rounded once to the weights' dtype; the partial tiles are added in
    slice order in float32, then the residual, then ``b2``."""
    d = x.shape[-1]
    y = layer_norm(x, ln_w, ln_b).to(w1.dtype).float()
    acc = None
    for m0, m1 in ffn_slices(w1.shape[0], m_split):
        h = F.gelu(torch.matmul(y, w1[m0:m1].float().t()) + b1[m0:m1].float())
        h = h.to(w2.dtype).float()
        part = torch.cat([torch.matmul(h, w2[d0:d0 + d // d_split, m0:m1].float().t())
                          for d0 in range(0, d, d // d_split)], dim=-1)
        acc = part if acc is None else acc + part
    return ((x.float() + acc) + b2.float()).to(x.dtype)


# mmer_fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2, out, partial, n_tok, d, m,
#                m_split, x_is_f32, stream)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# mmer_fused_ffn_reduce(x, b2, partial, out, n_tok, d, m_split, x_is_f32, stream)
_ARGTYPES_REDUCE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_ffn(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """``x + GELU(LN(x) @ w1ᵀ + b1) @ w2ᵀ + b2`` — the whole pre-norm FFN
    sublayer.

    x: (..., D) bfloat16 or float32; ln_w, ln_b: (D,) float32;
    w1: (M, D), w2: (D, M) in the compute dtype; b1: (M,), b2: (D,) in any
    float dtype (added in float32).  Returns x's shape and dtype.

    On CUDA the kernel takes bf16 weights, D in {768, 1024} and M a
    multiple of 256, and raises on anything else.  The grid follows
    :func:`ffn_plan`; a plan with more than one slice of M runs a second,
    reduce pass over an f32 workspace (counted in ``fused_ffn.reduce_launches``;
    ``fused_ffn.last_plan`` holds the plan of the latest launch).
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
    limit = ffn_limits(d, m)
    if limit:
        raise ValueError(f"fused_ffn: {limit}")
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
    n_tok = x.numel() // d
    plan = ffn_plan(n_tok, d, m, _sm_count(x.device))
    m_split = plan[2]
    out = torch.empty_like(x)
    partial = torch.empty(m_split, n_tok, d, dtype=torch.float32,
                          device=x.device) if m_split > 1 else None
    is_f32, stream = int(x.dtype == torch.float32), _build.stream_ptr(x.device)
    _build.call(
        "ffn", "mmer_fused_ffn", _ARGTYPES,
        _build.ptr(x), _build.ptr(vecs[0]), _build.ptr(vecs[1]), _build.ptr(w1),
        _build.ptr(vecs[2]), _build.ptr(w2), _build.ptr(vecs[3]), _build.ptr(out),
        _build.ptr(partial) if m_split > 1 else None, n_tok, d, m, m_split,
        is_f32, stream)
    fused_ffn.launches += 1
    fused_ffn.last_plan = plan
    if m_split > 1:
        _build.call("ffn", "mmer_fused_ffn_reduce", _ARGTYPES_REDUCE,
                    _build.ptr(x), _build.ptr(vecs[3]), _build.ptr(partial),
                    _build.ptr(out), n_tok, d, m_split, is_f32, stream)
        fused_ffn.reduce_launches += 1
    return out


fused_ffn.launches = 0
fused_ffn.reduce_launches = 0
fused_ffn.last_plan = None
_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def ln_matmul_reference(x, ln_w, ln_b, w) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_ln_matmul` (same arguments)."""
    y = layer_norm(x, ln_w, ln_b).to(w.dtype)
    return torch.matmul(y.float(), w.float().t()).to(w.dtype)


def ln_matmul_plan(n_tok: int, n: int, sm_count: int) -> tuple[int, int]:
    """``(rows, n_split)`` of the LN-matmul kernel's grid for ``n_tok``
    tokens and N output columns: ``ceil(n_tok / rows) * n_split`` blocks,
    block ``(x, y)`` computing its rows for the 256-column tiles ``[y T //
    n_split, (y + 1) T // n_split)`` of ``T = ceil(n / 256)``.  One slice when
    the row tiles alone put a block on every SM (a block then computes its
    LayerNorm once for all of N); otherwise enough slices to reach
    ``sm_count`` blocks, at most one tile a slice.  A function of the shape
    and the card alone."""
    if n_tok < 1 or n < 1 or sm_count < 1:
        raise ValueError(f"ln_matmul_plan: n_tok={n_tok}, n={n}, sm_count={sm_count}")
    rows = -(-n_tok // LN_MATMUL_ROWS)
    tiles = -(-n // LN_MATMUL_TILE)
    n_split = 1 if rows >= sm_count else min(tiles, -(-sm_count // rows))
    return LN_MATMUL_ROWS, n_split


def _lane_sums(v: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis of ``v`` (..., 32 lanes) as a warp's xor
    butterfly takes them (16, 8, 4, 2, 1), each lane adding its partner's."""
    lane = torch.arange(32, device=v.device)
    for d in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ d]
    return v[..., 0]


def ln_matmul_tiled_reference(x, ln_w, ln_b, w) -> torch.Tensor:
    """:func:`fused_ln_matmul` in the order of operations of
    ``csrc/ln_matmul.cu`` (same arguments; D a multiple of 256): the
    LayerNorm statistics as ``common.cuh:ln_tile_bf16_sw128`` takes them
    (lane l holds the 8-column chunks l + 32 i and sums them in (i, column)
    order, then the warp's xor butterfly), the LN output rounded once to
    w's dtype, the f32 product summed over K in 64-deep steps in step order,
    rounded once."""
    d = x.shape[-1]
    xf = x.float()
    v = xf.unflatten(-1, (d // 256, 32, 8))                 # (..., i, lane, e)
    s = torch.zeros_like(v[..., 0, :, 0])
    ss = torch.zeros_like(s)
    for i in range(d // 256):
        for e in range(8):
            s, ss = s + v[..., i, :, e], ss + v[..., i, :, e] * v[..., i, :, e]
    mean = (_lane_sums(s) / d)[..., None]
    var = (_lane_sums(ss) / d)[..., None] - mean * mean
    rstd = 1.0 / torch.sqrt(var.clamp_min(0.0) + LN_EPS)
    y = ((xf - mean) * rstd * ln_w.float() + ln_b.float()).to(w.dtype).float()
    acc = torch.zeros(*x.shape[:-1], w.shape[0], device=x.device)
    for k0 in range(0, d, LN_MATMUL_KSTEP):
        acc = acc + torch.matmul(y[..., k0:k0 + LN_MATMUL_KSTEP],
                                 w[:, k0:k0 + LN_MATMUL_KSTEP].float().t())
    return acc.to(w.dtype)


# mmer_fused_ln_matmul(x, ln_w, ln_b, w, out, n_tok, d, n, x_is_f32, stream,
#                      n_split)
_ARGTYPES_LN_MATMUL = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                       + [ctypes.c_int])


def fused_ln_matmul(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``LayerNorm(x) @ wᵀ``: float32 LayerNorm (:func:`layer_norm`) rounded
    to ``w``'s dtype, the product accumulated in float32 and rounded once.

    x: (..., D) bfloat16 or float32; ln_w, ln_b: (D,) float32; w: (N, D) in
    the compute dtype, the ``nn.Linear`` layout (the JAX function takes the
    transpose, (D, N)).  Returns (..., N) in **w's** dtype.

    On CUDA the kernel takes a bf16 weight and what :func:`ln_matmul_limits`
    allows, and raises on anything else.  The grid follows
    :func:`ln_matmul_plan` (``fused_ln_matmul.last_plan`` holds the plan of
    the latest launch).
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
    limit = ln_matmul_limits(d, n)
    if limit:
        raise ValueError(f"fused_ln_matmul: {limit}")
    vecs = [t.float().contiguous() for t in (ln_w, ln_b)]
    if [t.numel() for t in vecs] != [d, d]:
        raise ValueError("fused_ln_matmul: LN params must be (D,), (D,)")
    for t in (x, w, *vecs):
        if t.device != x.device:
            raise ValueError("fused_ln_matmul: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("fused_ln_matmul: tensors must be contiguous")
    out = torch.empty(*x.shape[:-1], n, dtype=w.dtype, device=x.device)
    n_tok = x.numel() // d
    plan = ln_matmul_plan(n_tok, n, _sm_count(x.device))
    _build.call(
        "ln_matmul", "mmer_fused_ln_matmul", _ARGTYPES_LN_MATMUL,
        _build.ptr(x), _build.ptr(vecs[0]), _build.ptr(vecs[1]), _build.ptr(w),
        _build.ptr(out), n_tok, d, n, int(x.dtype == torch.float32),
        _build.stream_ptr(x.device), plan[1])
    fused_ln_matmul.launches += 1
    fused_ln_matmul.last_plan = plan
    return out


fused_ln_matmul.launches = 0
fused_ln_matmul.last_plan = None
