"""Wav2Vec2 conv feature encoder, the port of ``mmer_tpu/ops/conv_pyramid.py``.

:func:`fused_conv_encoder` maps a waveform (B, L) to frame features
(B, T, 512): seven VALID conv layers, each conv → bias → LayerNorm → exact-erf
GELU.  It has two hand-written routes on a CUDA tensor:

- ``mega=True`` (default): every layer is one launch of
  ``csrc/conv_encoder.cu`` (the port of the Pallas ``_mega_kernel``), which
  runs the conv as a GEMM over im2col rows staged in shared memory and applies
  the epilogue before anything returns to device memory;
- ``mega=False``: the per-layer route of the JAX function, a second,
  independent formulation.  Layer 0 multiplies explicit patches
  (:func:`_l0_patches`) through :func:`_call_gemm`; every later layer sees
  the ``(B, T, C)`` activation as ``(B, T/2, 2C)`` stride-merged rows (a free
  view, lengths padded to even), a kernel-2 layer again through
  :func:`_call_gemm` and a kernel-3 layer through :func:`_call_k3` with the
  weight split ``[W0;W1]`` + ``W2``.  Their kernels are
  ``csrc/conv_layers.cu`` (the ports of ``_gemm_kernel`` and ``_k3_kernel``).

On CUDA both routes take a bf16 compute dtype and 512 channels in every
layer, and ``mega=True`` a first layer of at most MAX_FIRST_TAPS taps:
:func:`kernel_limits` names the first of these a config breaks, so that a
model refuses it when it is built.

On a CPU tensor ``mega=True`` runs :func:`conv_encoder_reference` and
``mega=False`` the same composition over :func:`gemm_ln_gelu_reference` and
:func:`k3_ln_gelu_reference`.

Every layer of K >= 64 on either route runs one body (``csrc/conv_tile.cuh``:
64-row tiles, 64-deep K steps, the LayerNorm statistics of the two
256-channel halves added); layer 0 of each route has a kernel of its own on
the CUDA cores (a warp a row, the statistics a warp's sum).
:func:`tiled_conv_encoder_reference`, :func:`tiled_k3_reference` and
:func:`tiled_gemm_reference` repeat their order of operations in plain
PyTorch for the CPU tests.

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

from mmer_tpu_torch.config import compute_dtype_limit, torch_dtype
from mmer_tpu_torch.ops import _build
from mmer_tpu_torch.ops.fused_blocks import LN_EPS, layer_norm

__all__ = ["MAX_FIRST_TAPS", "conv_encoder_reference", "fused_conv_encoder",
           "gemm_ln_gelu_reference", "gemm_weight", "halves_row_stats",
           "k3_ln_gelu_reference", "kernel_limits", "lane_row_stats",
           "supports_config", "tiled_conv_encoder_reference", "tiled_gemm_reference",
           "tiled_k3_reference"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def supports_config(cfg) -> bool:
    """The HF Wav2Vec2 feature-encoder family the port covers, as the JAX
    function's: layer-norm variant, any first layer, then stride-2 layers
    with kernel 2 or 3.  What the CUDA kernels take within it (the first
    layer's taps on ``mega=True``, the widths): :func:`kernel_limits`."""
    return (cfg.feat_extract_norm == "layer"
            and all(s == 2 and k in (2, 3)
                    for k, s in zip(cfg.conv_kernels[1:], cfg.conv_strides[1:])))


# Taps of the first layer that csrc/conv_encoder.cu's layer-0 kernel takes
# (its weight and window live in shared memory); mega=False takes any.
MAX_FIRST_TAPS = 16
CONV_CHANNELS = 512


def kernel_limits(cfg, mega: bool = True) -> str | None:
    """The first limit of the CUDA conv kernels that ``cfg`` breaks on the
    route ``mega`` picks, as a sentence naming it; None if it breaks none.
    A function of the config alone: the CPU versions take any config that
    :func:`supports_config` accepts."""
    if not supports_config(cfg):
        return (f"conv stack outside the ported family (kernels "
                f"{tuple(cfg.conv_kernels)}, strides {tuple(cfg.conv_strides)}, "
                f"norm {cfg.feat_extract_norm})")
    dtype_limit = compute_dtype_limit(cfg)
    if dtype_limit:
        return dtype_limit
    if any(d != CONV_CHANNELS for d in cfg.conv_dims):
        return (f"the conv kernels take {CONV_CHANNELS} channels in every layer, "
                f"got conv_dims {tuple(cfg.conv_dims)}")
    if mega and cfg.conv_kernels[0] > MAX_FIRST_TAPS:
        return (f"the mega=True layer-0 kernel takes at most {MAX_FIRST_TAPS} "
                f"first-layer taps, got {cfg.conv_kernels[0]}; mega=False takes any")
    return None


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


def _epilogue(y32: torch.Tensor, cb: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """bias add → LayerNorm → exact-erf GELU with the Pallas ``_epilogue``'s
    rounding points: the f32 sums rounded to ``dt``, the bias added in
    ``dt``, LayerNorm in f32 rounded to ``dt``, GELU in f32 rounded."""
    y = y32.to(dt) + cb.to(dt)
    y = layer_norm(y, scale, bias).to(dt)
    return F.gelu(y.float()).to(dt)


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
        x = _epilogue(torch.matmul(rows, wg.t()), cb, lw, lb, dt)
    return x


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` rows of (B, T, K), zero rows where T < n."""
    return x[:, :n] if x.shape[1] >= n else F.pad(x, (0, 0, 0, n - x.shape[1]))


def gemm_ln_gelu_reference(x: torch.Tensor, w: torch.Tensor, cb: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           t_pad: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`_call_gemm` (same arguments)."""
    y32 = torch.matmul(_rows(x, t_pad).float(), w.float())
    return _epilogue(y32, cb, scale, bias, x.dtype)


def k3_ln_gelu_reference(xm: torch.Tensor, w01: torch.Tensor, w2: torch.Tensor,
                         cb: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, t_pad: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`_call_k3` (same arguments)."""
    c = w2.shape[0]
    rows = _rows(xm, t_pad + 1).float()
    y32 = torch.matmul(rows[:, :t_pad], w01.float()) \
        + torch.matmul(rows[:, 1:, :c], w2.float())
    return _epilogue(y32, cb, scale, bias, xm.dtype)


# The CUDA kernels' tiling (csrc/conv_tile.cuh): output rows a block, K a step.
CONV_ROWS, CONV_KSTEP = 64, 64


def tiled_conv_sums(x: torch.Tensor, row_stride: int, kdim: int, t_rows: int,
                    w: torch.Tensor) -> torch.Tensor:
    """The product of the kernels' shared body in plain PyTorch: row t of the
    operand is the ``kdim`` values of clip b's flattened activation ``x[b]``
    that start at ``t * row_stride``; rows come in tiles of CONV_ROWS and K in
    steps of CONV_KSTEP, whose f32 products are added in step order.  A value
    at or beyond the end of its clip's array, and every row at or beyond
    ``t_rows``, reads as zero: the clips are gathered from one flat array, so
    a value past a clip's end would otherwise be the next clip's.  ``w`` is
    (kdim, N); returns (B, rows, N) f32 sums, ``rows`` = t_rows rounded up to
    whole tiles."""
    bsz = x.shape[0]
    n = x[0].numel()
    flat = x.reshape(-1)
    rows = _round_up(t_rows, CONV_ROWS)
    r = torch.arange(rows, device=x.device)[:, None]
    idx = r * row_stride + torch.arange(kdim, device=x.device)[None, :]
    valid = (idx < n) & (r < t_rows)
    start = torch.arange(bsz, device=x.device)[:, None, None] * n
    a = flat[(start + idx).clamp(max=flat.numel() - 1)].float()
    a = torch.where(valid, a, torch.zeros((), dtype=a.dtype, device=x.device))
    acc = torch.zeros(bsz, rows, w.shape[1], device=x.device)
    for k0 in range(0, kdim, CONV_KSTEP):
        acc = acc + torch.matmul(a[..., k0:k0 + CONV_KSTEP],
                                 w[k0:k0 + CONV_KSTEP].float())
    return acc


def halves_row_stats(y: torch.Tensor):
    """Each row's sum and sum of squares as the wgmma body takes them: over
    each half of the channels (a warpgroup's), then added, first half first."""
    c = y.shape[-1]
    lo, hi = y[..., :c // 2], y[..., c // 2:]
    return (lo.sum(-1, keepdim=True) + hi.sum(-1, keepdim=True),
            (lo * lo).sum(-1, keepdim=True) + (hi * hi).sum(-1, keepdim=True))


def lane_row_stats(y: torch.Tensor):
    """Each row's sum and sum of squares as the layer-0 kernel takes them:
    lane l of a warp holds channels 128 g + 4 l + e and adds them in (g, e)
    order, then the 32 lanes' sums meet in an xor butterfly (16, 8, 4, 2,
    1), each lane adding its partner's sum to its own."""
    c = y.shape[-1]
    v = F.pad(y, (0, -c % 128)).unflatten(-1, (-1, 32, 4))    # (..., g, lane, e)
    s = torch.zeros_like(v[..., 0, :, 0])
    ss = torch.zeros_like(s)
    for g in range(v.shape[-3]):
        for e in range(4):
            x = v[..., g, :, e]
            s, ss = s + x, ss + x * x
    lane = torch.arange(32, device=y.device)
    for d in (16, 8, 4, 2, 1):
        s, ss = s + s[..., lane ^ d], ss + ss[..., lane ^ d]
    return s[..., :1], ss[..., :1]


def tiled_epilogue(y32: torch.Tensor, cb: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, dt: torch.dtype,
                   row_stats=halves_row_stats) -> torch.Tensor:
    """:func:`_epilogue` with a kernel's LayerNorm statistics: each row's
    sum and sum of squares in the order of ``row_stats``
    (:func:`halves_row_stats` for the wgmma body, :func:`lane_row_stats` for
    layer 0)."""
    y = (y32.to(dt) + cb.to(dt)).float()
    c = y.shape[-1]
    s, ss = row_stats(y)
    mean = s / c
    rstd = 1.0 / torch.sqrt((ss / c - mean * mean).clamp_min(0.0) + LN_EPS)
    ln = ((y - mean) * rstd * scale.float() + bias.float()).to(dt)
    return F.gelu(ln.float()).to(dt)


def tiled_conv_encoder_reference(wave: torch.Tensor, weights: Sequence[torch.Tensor],
                                 biases: Sequence[torch.Tensor],
                                 ln_weights: Sequence[torch.Tensor],
                                 ln_biases: Sequence[torch.Tensor], cfg) -> torch.Tensor:
    """``fused_conv_encoder(mega=True)`` in the order of operations of
    ``csrc/conv_encoder.cu``, in plain PyTorch (same arguments): layer 0 on
    its own path, output (t, n) summed tap by tap in f32 over the rounded
    waveform and weight, its statistics by :func:`lane_row_stats`; every
    later layer through :func:`tiled_conv_sums` over the im2col rows of the
    unmerged activation against the K-major weight, its statistics by
    :func:`halves_row_stats`; :func:`tiled_epilogue` after each."""
    _check_args(wave, weights, cfg)
    dt = torch_dtype(cfg)
    x = wave.to(dt).unsqueeze(-1)                          # (B, L, 1)
    for i, (w, cb, lw, lb, k, s) in enumerate(zip(
            weights, biases, ln_weights, ln_biases, cfg.conv_kernels,
            cfg.conv_strides)):
        bsz, t_in, c_in = x.shape
        t_out = (t_in - k) // s + 1
        kdim = k * c_in
        wg = gemm_weight(w, dt)[:, :kdim].float()          # (C, kdim)
        if i == 0:
            rows = x.unfold(1, k, s).permute(0, 1, 3, 2).reshape(bsz, t_out, kdim)
            acc = torch.zeros(bsz, t_out, wg.shape[0], device=x.device)
            for tap in range(kdim):
                acc = acc + rows[..., tap:tap + 1].float() * wg[:, tap]
            x = tiled_epilogue(acc, cb, lw, lb, dt, lane_row_stats)
        else:
            acc = tiled_conv_sums(x, s * c_in, kdim, t_out, wg.t())[:, :t_out]
            x = tiled_epilogue(acc, cb, lw, lb, dt)
    return x


def tiled_gemm_reference(x: torch.Tensor, w: torch.Tensor, cb: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         t_pad: int) -> torch.Tensor:
    """:func:`_call_gemm` in the order of operations of ``csrc/conv_layers.cu``
    (same arguments).  K >= CONV_KSTEP: the wgmma body, row t of the operand
    the K values of clip b's flattened rows at ``t * K``, through
    :func:`tiled_conv_sums`, statistics by :func:`halves_row_stats`.  K below
    it (layer 0's patches): the CUDA-core kernel, each output summed k by k in
    f32, statistics by :func:`lane_row_stats`.  Rows of ``x`` at or beyond T
    read as zero."""
    kdim = x.shape[2]
    if kdim >= CONV_KSTEP:
        y32 = tiled_conv_sums(x, kdim, kdim, t_pad, w)[:, :t_pad]
        return tiled_epilogue(y32, cb, scale, bias, x.dtype)
    rows = _rows(x, t_pad).float()
    acc = torch.zeros(x.shape[0], t_pad, w.shape[1], device=x.device)
    for k in range(kdim):
        acc = acc + rows[..., k:k + 1] * w[k].float()
    return tiled_epilogue(acc, cb, scale, bias, x.dtype, lane_row_stats)


def tiled_k3_reference(xm: torch.Tensor, w01: torch.Tensor, w2: torch.Tensor,
                       cb: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       t_pad: int) -> torch.Tensor:
    """:func:`_call_k3` in the order of operations of ``csrc/conv_layers.cu``
    (same arguments): row t of the operand is the 3C contiguous values at
    merged row t, multiplied by ``[w01; w2]`` through :func:`tiled_conv_sums`."""
    c2 = xm.shape[2]
    y32 = tiled_conv_sums(xm, c2, c2 + w2.shape[0], t_pad,
                          torch.cat([w01, w2]))[:, :t_pad]
    return tiled_epilogue(y32, cb, scale, bias, xm.dtype)


def _check_layer_args(name: str, x, mats, vecs) -> list:
    """Refuse what the kernels of ``csrc/conv_layers.cu`` do not take; return
    the three (512,) vectors as contiguous f32."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in (x, *mats):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one device")
    vecs = [t.float().contiguous() for t in vecs]
    if any(t.shape != (512,) or t.device != x.device for t in vecs):
        raise ValueError(f"{name}: kernel needs 512 output channels, vectors "
                         "on the operand's device")
    return vecs


# mmer_gemm_ln_gelu(x, w, cb, ln_w, ln_b, out, batch, x_rows, kdim, c_out,
#                   t_rows, stream, grid)
_ARGTYPES_GEMM = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
# mmer_k3_ln_gelu(xm, w01, w2, cb, ln_w, ln_b, out, batch, th, c_in, c_out,
#                 t_rows, stream)
_ARGTYPES_K3 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _call_gemm(x: torch.Tensor, w: torch.Tensor, cb: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, t_pad: int) -> torch.Tensor:
    """Rows times weight → bias → LayerNorm → GELU: ``x`` (B, T, K) holds
    layer-0 patches or stride-merged rows of a kernel-2 layer, ``w`` is
    (K, 512); returns (B, t_pad, 512) in x's dtype.  Rows of ``x`` at or
    beyond T read as zero.  On CUDA: bf16, K a multiple of 16; K >= 64 runs
    the wgmma body, a smaller K the CUDA-core kernel; ``_call_gemm.last_grid``
    holds the grid (blocks along the rows, clips) of the latest launch."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2] or t_pad < 1:
        raise ValueError(f"_call_gemm: x (B, T, K) and w (K, C) expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, t_pad {t_pad}")
    if x.device.type == "cpu":
        return gemm_ln_gelu_reference(x, w, cb, scale, bias, t_pad)
    vecs = _check_layer_args("_call_gemm", x, (w,), (cb, scale, bias))
    bsz, x_rows, kdim = x.shape
    if kdim % 16 or w.shape[1] != 512:
        raise ValueError(f"_call_gemm: kernel needs K % 16 == 0 and 512 output "
                         f"channels, got w {tuple(w.shape)}")
    out = torch.empty((bsz, t_pad, 512), dtype=x.dtype, device=x.device)
    grid = (ctypes.c_int * 2)()
    _build.call("conv_layers", "mmer_gemm_ln_gelu", _ARGTYPES_GEMM,
                _build.ptr(x), _build.ptr(w), *(_build.ptr(t) for t in vecs),
                _build.ptr(out), bsz, x_rows, kdim, 512, t_pad,
                _build.stream_ptr(x.device), ctypes.addressof(grid))
    _call_gemm.launches += 1
    _call_gemm.last_grid = tuple(grid)
    return out


def _call_k3(xm: torch.Tensor, w01: torch.Tensor, w2: torch.Tensor,
             cb: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             t_pad: int) -> torch.Tensor:
    """Kernel-3 stride-2 conv on the merged view → bias → LayerNorm → GELU:
    output row t is ``xm[t] @ w01 + xm[t+1, :C] @ w2`` with ``xm``
    (B, T/2, 2C), ``w01`` (2C, 512) the first two taps stacked and ``w2``
    (C, 512) the third; returns (B, t_pad, 512).  Merged rows at or beyond
    T/2 read as zero.  On CUDA: bf16, C = 512."""
    if xm.dim() != 3 or w01.shape[0] != xm.shape[2] \
            or 2 * w2.shape[0] != xm.shape[2] or w01.shape[1] != w2.shape[1] \
            or t_pad < 1:
        raise ValueError(f"_call_k3: xm (B, T/2, 2C), w01 (2C, N), w2 (C, N) "
                         f"expected, got {tuple(xm.shape)}, {tuple(w01.shape)}, "
                         f"{tuple(w2.shape)}, t_pad {t_pad}")
    if xm.device.type == "cpu":
        return k3_ln_gelu_reference(xm, w01, w2, cb, scale, bias, t_pad)
    vecs = _check_layer_args("_call_k3", xm, (w01, w2), (cb, scale, bias))
    bsz, th, c2 = xm.shape
    if c2 != 1024 or w2.shape[1] != 512:
        raise ValueError(f"_call_k3: kernel needs 512 channels in and out, got "
                         f"xm {tuple(xm.shape)}, w2 {tuple(w2.shape)}")
    out = torch.empty((bsz, t_pad, 512), dtype=xm.dtype, device=xm.device)
    _build.call("conv_layers", "mmer_k3_ln_gelu", _ARGTYPES_K3,
                _build.ptr(xm), _build.ptr(w01), _build.ptr(w2),
                *(_build.ptr(t) for t in vecs), _build.ptr(out), bsz, th,
                c2 // 2, 512, t_pad, _build.stream_ptr(xm.device))
    _call_k3.launches += 1
    return out


_call_gemm.launches = 0
_call_gemm.last_grid = None
_call_k3.launches = 0


def _l0_patches(wave: torch.Tensor, k: int, s: int, t_pad: int,
                dt: torch.dtype) -> torch.Tensor:
    """(B, t_pad, K) layer-0 patches in ``dt``: row t holds samples
    ``[s·t, s·t + k)``, zero past the waveform's end, and K is k rounded up
    to 16 (the tensor cores' tile depth) with zero columns."""
    need = (t_pad - 1) * s + k
    if need > wave.shape[1]:
        wave = F.pad(wave, (0, need - wave.shape[1]))
    p = wave[:, :need].unfold(1, k, s)                     # (B, t_pad, k)
    return F.pad(p, (0, _round_up(k, 16) - k)).to(dt)


def _per_layer_encoder(wave, weights, biases, ln_weights, ln_biases,
                       cfg) -> torch.Tensor:
    """``fused_conv_encoder(mega=False)``: one :func:`_call_gemm` or
    :func:`_call_k3` per layer over the stride-merged view."""
    dt = torch_dtype(cfg)
    bsz = wave.shape[0]
    k0, s0 = cfg.conv_kernels[0], cfg.conv_strides[0]
    t = (wave.shape[1] - k0) // s0 + 1
    t_pad = _round_up(t, 2)
    patches = _l0_patches(wave, k0, s0, t_pad, dt)
    w0 = weights[0][:, 0, :].t()                           # (k0, C)
    w0 = F.pad(w0, (0, 0, 0, patches.shape[2] - k0)).to(dt).contiguous()
    a = _call_gemm(patches, w0, biases[0], ln_weights[0], ln_biases[0], t_pad)
    for i in range(1, len(weights)):
        c, c_in, k = weights[i].shape
        t = (t - k) // 2 + 1
        t_pad = _round_up(t, 2)
        xm = a.view(bsz, a.shape[1] // 2, 2 * c_in)        # same bytes
        w = weights[i].permute(2, 1, 0).to(dt).contiguous()    # (k, c_in, c)
        w01 = w[:2].reshape(2 * c_in, c)
        if k == 2:
            a = _call_gemm(xm, w01, biases[i], ln_weights[i], ln_biases[i], t_pad)
        else:
            a = _call_k3(xm, w01, w[2], biases[i], ln_weights[i],
                         ln_biases[i], t_pad)
    return a[:, :t]


# mmer_conv_ln_gelu(x, w, cb, ln_w, ln_b, out, batch, t_in, t_out, c_in,
#                   c_out, k, stride, kp, x_is_f32, stream, grid)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2


def fused_conv_encoder(wave: torch.Tensor, weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor],
                       ln_weights: Sequence[torch.Tensor],
                       ln_biases: Sequence[torch.Tensor], cfg,
                       mega: bool = True) -> torch.Tensor:
    """Waveform (B, L) float32 → frame features (B, T, conv_dims[-1]) in
    the compute dtype, T from ``feat_extract_output_length``.

    ``weights[i]`` is layer i's Conv1d weight (C_out, C_in, k); ``biases``,
    ``ln_weights``, ``ln_biases`` its conv bias and LayerNorm params.
    ``mega`` picks the route (module docstring).  On CUDA the kernels take
    what :func:`kernel_limits` allows; ``fused_conv_encoder.last_grids``
    holds the grid (blocks along the frames, clips) each layer's launch of
    the latest ``mega=True`` call used.
    """
    if wave.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv_encoder: unsupported device {wave.device}")
    if wave.device.type == "cpu" and mega:
        return conv_encoder_reference(wave, weights, biases, ln_weights,
                                      ln_biases, cfg)
    _check_args(wave, weights, cfg)
    if wave.device.type == "cuda" and (torch_dtype(cfg) != torch.bfloat16
                                       or wave.dtype != torch.float32):
        raise TypeError("fused_conv_encoder: the CUDA kernel takes an f32 "
                        "waveform and a bf16 compute dtype")
    if not mega:
        return _per_layer_encoder(wave, weights, biases, ln_weights, ln_biases,
                                  cfg)
    if cfg.conv_kernels[0] > MAX_FIRST_TAPS:
        raise ValueError(f"fused_conv_encoder: {kernel_limits(cfg, mega)}")
    stream = _build.stream_ptr(wave.device)
    x = wave.contiguous()
    bsz = x.shape[0]
    grids = []
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
        grid = (ctypes.c_int * 2)()
        _build.call(
            "conv_encoder", "mmer_conv_ln_gelu", _ARGTYPES,
            _build.ptr(x), _build.ptr(wg), _build.ptr(vecs[0]),
            _build.ptr(vecs[1]), _build.ptr(vecs[2]), _build.ptr(out),
            bsz, t_in, t_out, c_in, c_out, k, s, wg.shape[1],
            int(x.dtype == torch.float32), stream, ctypes.addressof(grid))
        fused_conv_encoder.launches += 1
        grids.append(tuple(grid))
        x = out
    fused_conv_encoder.last_grids = grids
    return x


fused_conv_encoder.launches = 0
fused_conv_encoder.last_grids = []
