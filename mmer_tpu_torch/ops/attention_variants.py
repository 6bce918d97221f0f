"""Ablated variants of the attention kernel, the port of the kernels in
``scripts/probe_attn.py`` (``run_variant``).

Seven modes of one attention over ``(B, H, S, 64)`` tensors, each the
production kernel of ``csrc/attention.cu`` with one cost taken out or moved,
so that timing them side by side says where the kernel's time goes:

- ``full``: keys at or beyond S masked out; the production kernel itself,
  launched through :func:`flash_attention`;
- ``nomask``: q, k, v zero-padded to ``s_pad`` and the zero keys **take
  part** (score 0, value 0): no mask pass;
- ``noexp``: as ``nomask`` with ``p = scores − max`` (no exp;
  numerics-invalid, isolates the transcendental);
- ``nosoftmax``: as ``nomask`` with ``p = scores`` (numerics-invalid; two
  products only, the tensor-core floor of the design);
- ``mxumask``: q gets a 65th column of ones, k a 65th column that is 0 on
  valid keys and bf16(−1e9) on padded ones, so the first product applies the
  mask; equals ``full`` to rounding;
- ``kt``: K arrives pre-transposed ``(B, H, 64, s_pad)``; equals ``full``;
- ``kt_nosoftmax``: the ``kt`` layout with ``p = scores``.

In every mode the scale is folded into q (×0.125 at depth 64, exact in
bf16), scores are float32, p is rounded to v's dtype before the second
product, the denominator is the sum of the **rounded** p, and the output is
numerator / denominator in q's dtype.

:func:`attention_variant` = :func:`variant_operands` (pads, transposes and
extra columns, plain PyTorch) + :func:`launch_variant` (the kernel); the
probe script times the launch alone over pre-staged operands.  On a CPU
tensor :func:`attention_variant` runs :func:`attention_variant_reference`,
which pads explicitly.  The TPU script derives ``s_pad`` from its VMEM block
model; here it is an argument (default: S rounded up to 128, the TPU
script's first step).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mmer_tpu_torch.ops import _build
from mmer_tpu_torch.ops.flash_attention import _check_qkv, flash_attention

MODES = ("full", "nomask", "noexp", "nosoftmax", "mxumask", "kt",
         "kt_nosoftmax")
# Modes whose output is a valid attention (equal to ``full`` to rounding).
VALID_MODES = ("full", "nomask", "mxumask", "kt")
MASK_BIAS = -1e9
# mmer_attention_variant's ``variant`` argument.
_VARIANT_ID = {"nomask": 0, "noexp": 1, "nosoftmax": 2, "mxumask": 3, "kt": 4,
               "kt_nosoftmax": 5}
_QK_DEPTH = 80      # the 65-column operands, zero-padded to the 16-deep MMA step


def default_s_pad(s: int) -> int:
    return -(-s // 128) * 128


def _check_mode(mode: str, s: int, s_pad: int) -> None:
    if mode not in MODES:
        raise ValueError(f"attention_variant: unknown mode {mode!r}; one of {MODES}")
    if s_pad < s:
        raise ValueError(f"attention_variant: s_pad {s_pad} < S {s}")


def _pad_rows(t: torch.Tensor, s_pad: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, s_pad - t.shape[-2]))


def attention_variant_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mode: str,
                                s_pad: Optional[int] = None,
                                return_parts: bool = False):
    """Plain PyTorch version of :func:`attention_variant`: explicit zero
    padding to ``s_pad``, one (S_pad, S_pad) score matrix per head.  With
    ``return_parts`` it returns (output, numerator, denominator), the last two
    in float32 over the S real query rows."""
    b, h, s, d = q.shape
    s_pad = default_s_pad(s) if s_pad is None else int(s_pad)
    _check_mode(mode, s, s_pad)
    qp = _pad_rows(q * (1.0 / math.sqrt(d)), s_pad)
    kp, vp = _pad_rows(k, s_pad), _pad_rows(v, s_pad)
    valid = torch.arange(s_pad, device=q.device) < s
    if mode == "mxumask":
        ones = torch.ones(b, h, s_pad, 1, dtype=q.dtype, device=q.device)
        bias = torch.where(valid, 0.0, MASK_BIAS).to(q.dtype)
        qp = torch.cat([qp, ones], dim=-1)
        kp = torch.cat([kp, bias[None, None, :, None].expand(b, h, s_pad, 1)],
                       dim=-1)
    scores = torch.matmul(qp.float(), kp.float().transpose(-1, -2))
    if mode in ("full", "kt"):
        scores = scores.masked_fill(~valid, float("-inf"))
    if mode in ("nosoftmax", "kt_nosoftmax"):
        p = scores
    else:
        p = scores - scores.amax(dim=-1, keepdim=True)
        if mode != "noexp":
            p = torch.exp(p)
    p = p.to(v.dtype).float()
    num = torch.matmul(p, vp.float())[:, :, :s]
    den = p.sum(dim=-1, keepdim=True)[:, :, :s]
    out = (num / den).to(q.dtype)
    return (out, num, den) if return_parts else out


def variant_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mode: str, s_pad: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (q, k, v) operands the kernel of ``mode`` takes, from unpadded
    (B, H, S, 64) tensors.  The kernels read rows past S of a (B, H, S, 64)
    operand as zeros, so only what cannot be zero-filled is materialised:
    the pre-transposed ``(B, H, 64, s_pad)`` K of the ``kt`` modes and the
    80-column q ``(B, H, S, 80)`` and k ``(B, H, s_pad, 80)`` of ``mxumask``
    (column 64 holds the ones / the key bias, columns 65-79 zeros; q carries
    the scale)."""
    b, h, s, d = q.shape
    s_pad = default_s_pad(s) if s_pad is None else int(s_pad)
    _check_mode(mode, s, s_pad)
    if mode in ("kt", "kt_nosoftmax"):
        return q, _pad_rows(k, s_pad).transpose(-1, -2).contiguous(), v
    if mode == "mxumask":
        qe = q.new_zeros(b, h, s, _QK_DEPTH)
        qe[..., :d] = q * (1.0 / math.sqrt(d))
        qe[..., d] = 1.0
        ke = k.new_zeros(b, h, s_pad, _QK_DEPTH)
        ke[:, :, :s, :d] = k
        ke[:, :, s:, d] = MASK_BIAS
        return qe, ke, v
    return q, k, v


# mmer_attention_variant(variant, q, k, v, out, bh, s, s_pad, scale, stream)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p]


def launch_variant(mode: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, s_pad: int) -> torch.Tensor:
    """Launch the kernel of ``mode`` on operands from :func:`variant_operands`
    (CUDA, contiguous bf16); returns (B, H, S, 64).  ``s_pad`` must be a
    multiple of the kernel's 64-key tile."""
    b, h, s, _ = v.shape
    _check_mode(mode, s, s_pad)
    if mode == "full":
        out = flash_attention(q, k, v)
        attention_variant.launches[mode] += 1
        return out
    if s_pad % 64:
        raise ValueError(f"attention_variant: the kernels need s_pad % 64 == 0, "
                         f"got {s_pad}")
    _check_qkv("attention_variant", v, v, v)
    dqk = _QK_DEPTH if mode == "mxumask" else 64
    k_shape = (b, h, 64, s_pad) if mode.startswith("kt") else (
        b, h, s_pad if mode == "mxumask" else s, dqk)
    if tuple(q.shape) != (b, h, s, dqk) or tuple(k.shape) != k_shape:
        raise ValueError(f"attention_variant[{mode}]: operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)} do not fit v {tuple(v.shape)}, "
                         f"s_pad {s_pad}")
    for t in (q, k):
        if t.dtype != torch.bfloat16 or t.device != v.device \
                or not t.is_contiguous():
            raise ValueError(f"attention_variant[{mode}]: q, k must be "
                             "contiguous bf16 on v's device")
    out = torch.empty_like(v)
    scale = 1.0 if mode == "mxumask" else 1.0 / math.sqrt(64)
    _build.call("attention", "mmer_attention_variant", _ARGTYPES,
                _VARIANT_ID[mode], _build.ptr(q), _build.ptr(k), _build.ptr(v),
                _build.ptr(out), b * h, s, s_pad, scale,
                _build.stream_ptr(v.device))
    attention_variant.launches[mode] += 1
    return out


def attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mode: str, s_pad: Optional[int] = None) -> torch.Tensor:
    """Mode ``mode`` of the attention probe over (B, H, S, D) tensors, zero
    padded to ``s_pad`` keys; returns (B, H, S, D) in q's dtype.  On a CPU
    tensor the plain version runs; on CUDA the kernel (contiguous bf16,
    D = 64, ``s_pad`` a multiple of 64) or an exception."""
    s_pad = default_s_pad(q.shape[-2]) if s_pad is None else int(s_pad)
    if q.device.type == "cpu":
        return attention_variant_reference(q, k, v, mode, s_pad)
    _check_qkv("attention_variant", q, k, v)
    return launch_variant(mode, *variant_operands(q, k, v, mode, s_pad), s_pad)


attention_variant.launches = {mode: 0 for mode in MODES}
