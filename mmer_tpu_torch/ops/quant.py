"""int8 products for the inference forwards of ``models/vivit_quant.py`` and
``models/wav2vec2_quant.py``, the port of ``mmer_tpu/ops/quant.py``.

The scheme is the JAX package's, to the bit:

- **weights** (:func:`quantize_weight`, once): symmetric per-output-channel
  absmax, ``s = max(absmax, 1e-12) / 127`` in float32, ``round(w / s)`` to
  int8;
- **activations** (:func:`row_quant`, every call): symmetric per-row absmax
  taken in x's own dtype (so the floor ``1e-8`` is rounded to bf16 for bf16
  rows), ``xs = absmax / 127`` in float32, ``round(x / xs)`` to int8;
- **product**: int8 × int8 summed in int32, dequantized as
  ``acc · xs[row] · ws[col]`` (:func:`qdot_int8`, :func:`qdot`);
- **pixels** (:func:`qdot_u8`): ``x - 128`` fits int8 exactly, so uint8
  rows are never quantized; ``((acc + corr[col]) · ws[col]) / denom`` with
  ``corr = 128 · Σ_K wq`` (:func:`u8_correction`).

Every round is half to even (``jnp.round``, ``torch.round``) and every
quotient a true division: a reciprocal multiply differs in the last bit of
the scale and, through it, in the output.  The optional ``bias`` is added to
the dequantized product (``qdot(...) + b``, one more float32 rounding), as at
the call sites where JAX adds a bias straight to the product.

**The kernel** (``csrc/qdot.cu``) is the port's own: JAX lets XLA compile an
int8 ``dot_general`` with the quantize and dequantize around it, which is
not a Pallas kernel.  ``row_quant`` computes a row's absmax, scale and int8
row from one read of the row; ``int8_gemm`` runs the product on the tensor
cores (``wgmma`` m64n256k32, s8 × s8 → s32, a persistent grid of 128 × 256
tiles) with the dequantize (and the bias) in its epilogue, and shifts uint8
pixels to int8 in shared memory before the tensor cores read them.  The
kernel reads the weight K-contiguous: :func:`quantize_weight` returns the
(K, N) table as the transposed view of an (N, K) buffer, so that the
kernel's operand is made once, when the weights are quantized, and never on
a call.

On a CPU tensor each public function runs its plain version
(:func:`row_quant_reference`, :func:`qdot_int8_reference`,
:func:`qdot_u8_reference`), which computes the int32 product exactly (as a
float64 product of integers: every partial sum is an integer below 2^53) on
any device.  On a CUDA tensor only the kernel runs, and a shape or layout it
does not take raises (:func:`qdot_limits`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mmer_tpu_torch.ops import _build

W_FLOOR = 1e-12      # the weight scale's floor (float32)
X_FLOOR = 1e-8       # the row scale's floor, in the row's dtype
K_TILE = 64          # K a multiple of this (the GEMM zero-fills its last 128-byte step)
N_ALIGN = 8          # the GEMM's epilogue takes column pairs of an n8 group
# |x8| <= 128 and |wq| <= 127: with corr, |acc + corr| <= 2 * 128 * 127 * K,
# which stays inside int32 up to this depth.
K_MAX = 65536
M_MAX = 65535 * 128  # rows: the GEMM counts its tiles and K steps in int32


def qdot_limits(k: int, n: int) -> str | None:
    """The first limit of the int8 GEMM kernel that a (K, N) weight breaks,
    as a sentence naming it; None if it breaks none.  The plain versions
    take any shape."""
    if k % K_TILE:
        return f"the int8 GEMM kernel takes K a multiple of {K_TILE}, got {k}"
    if not 0 < k <= K_MAX:
        return f"the int8 GEMM kernel takes 0 < K <= {K_MAX}, got {k}"
    if n % N_ALIGN or n < 1:
        return f"the int8 GEMM kernel takes N a multiple of {N_ALIGN}, got {n}"
    return None


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


# -- weights -------------------------------------------------------------------

def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float → (int8 (K, N), f32 (1, N) per-output-channel scale).
    The int8 table is the transposed view of an (N, K) contiguous buffer,
    the layout the kernel reads."""
    wt = w.detach().t().float().contiguous()                    # (N, K)
    s = _div(wt.abs().amax(dim=1).clamp_min(W_FLOOR), 127.0)    # (N,)
    qt = torch.round(wt / s[:, None]).to(torch.int8)
    return qt.t(), s[None, :]


def u8_correction(wq: torch.Tensor) -> torch.Tensor:
    """The per-output-channel 128-shift correction of :func:`qdot_u8`,
    ``128 · Σ_K wq``, int32 (N,)."""
    return 128 * wq.to(torch.int32).sum(dim=0, dtype=torch.int32)


# -- plain versions ------------------------------------------------------------

def row_quant_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float (..., K) → (int8 (..., K), f32 (..., 1) row scale): the absmax
    in x's dtype, floored at ``1e-8`` in that dtype, over 127 in float32."""
    floor = torch.tensor(X_FLOOR, dtype=x.dtype, device=x.device)
    xs = _div(torch.maximum(x.abs().amax(dim=-1, keepdim=True), floor).float(),
              127.0)
    return torch.round(x.float() / xs).to(torch.int8), xs


def _int_product(a8: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) × int8 (K, N) → the exact int32 (..., N): a float64
    product of integers, whose every partial sum is an integer below 2^53."""
    return torch.matmul(a8.double(), wq.double()).to(torch.int32)


def qdot_int8_reference(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                        ws: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`qdot_int8`: ``acc · xs · ws`` (+ bias), f32."""
    out = _int_product(xq, wq).float() * xs * ws
    return out if bias is None else out + bias


def qdot_reference(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`qdot`."""
    return qdot_int8_reference(*row_quant_reference(x), wq, ws, bias)


def _shift_u8(x_u8: torch.Tensor) -> torch.Tensor:
    return (x_u8.to(torch.int32) - 128).to(torch.int8)


def qdot_u8_reference(x_u8: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      corr: torch.Tensor, denom: float = 255.0,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`qdot_u8`: ``((acc + corr) · ws) / denom``
    (+ bias), f32."""
    acc = _int_product(_shift_u8(x_u8), wq) + corr
    out = _div(acc.float() * ws, denom)
    return out if bias is None else out + bias


# -- the kernels ---------------------------------------------------------------

# mmer_row_quant(x, is_bf16, xq, xs, rows, k, floor, stream)
_ROW_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# mmer_int8_gemm(a, u8, bt, xs, ws, corr, bias, out, m, n, k, denom, stream)
_GEMM_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]


def _check_rows(name: str, x: torch.Tensor, dtypes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {dtypes}, got {x.dtype}")
    if not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"{name}: rows must be contiguous (..., K)")


def _check_weight(name: str, x: torch.Tensor, wq: torch.Tensor,
                  ws: torch.Tensor, bias: Optional[torch.Tensor]) -> int:
    """Checks the operands of the GEMM on the card; returns N."""
    if wq.dim() != 2 or wq.dtype != torch.int8 or wq.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: wq must be int8 (K, N) with K = "
                         f"{x.shape[-1]}, got {wq.dtype} {tuple(wq.shape)}")
    k, n = wq.shape
    limit = qdot_limits(k, n)
    if limit:
        raise ValueError(f"{name}: {limit}")
    if not wq.t().is_contiguous():
        raise ValueError(f"{name}: the kernel reads wq K-contiguous: pass the "
                         "(K, N) view that quantize_weight returns")
    if ws.dtype != torch.float32 or ws.numel() != n or not ws.is_contiguous():
        raise ValueError(f"{name}: ws must be contiguous float32 (1, N)")
    if bias is not None and (bias.dtype != torch.float32 or bias.numel() != n
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous float32 (N,)")
    for t in (wq, ws) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError(f"{name}: every operand must be on {x.device}")
    return n


def _gemm(wrapper, a: torch.Tensor, xs: Optional[torch.Tensor],
          wq: torch.Tensor, ws: torch.Tensor, corr: Optional[torch.Tensor],
          bias: Optional[torch.Tensor], denom: float) -> torch.Tensor:
    """One launch of ``int8_gemm`` (uint8 rows when ``a`` is uint8), counted
    on ``wrapper``."""
    k, n = wq.shape
    m = a.numel() // k
    if m > M_MAX:
        raise ValueError(f"{wrapper.__name__}: the int8 GEMM kernel takes at most "
                         f"{M_MAX} rows, got {m}")
    out = torch.empty(*a.shape[:-1], n, dtype=torch.float32, device=a.device)
    if m:
        _build.call("qdot", "mmer_int8_gemm", _GEMM_ARGTYPES,
                    _build.ptr(a), int(a.dtype == torch.uint8), _build.ptr(wq),
                    None if xs is None else _build.ptr(xs), _build.ptr(ws),
                    None if corr is None else _build.ptr(corr),
                    None if bias is None else _build.ptr(bias), _build.ptr(out),
                    m, n, k, denom, _build.stream_ptr(a.device))
        wrapper.launches += 1
    return out


def row_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 or bf16 (..., K) → (int8 (..., K), f32 (..., 1) row scale),
    one row a warp on the card."""
    if x.device.type == "cpu":
        return row_quant_reference(x)
    _check_rows("row_quant", x, (torch.float32, torch.bfloat16))
    k = x.shape[-1]
    if k % 8:
        raise ValueError(f"row_quant: the kernel takes K a multiple of 8, got {k}")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    xs = torch.empty(*x.shape[:-1], 1, dtype=torch.float32, device=x.device)
    rows = x.numel() // k
    if rows:
        floor = float(torch.tensor(X_FLOOR, dtype=x.dtype))
        _build.call("qdot", "mmer_row_quant", _ROW_ARGTYPES,
                    _build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(xq),
                    _build.ptr(xs), rows, k, floor, _build.stream_ptr(x.device))
        row_quant.launches += 1
    return xq, xs


def qdot_int8(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
              ws: torch.Tensor, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """int8 (..., K) rows with their f32 (..., 1) scales × int8 (K, N) →
    f32 (..., N) = ``acc · xs · ws`` (+ bias): the GEMM and its epilogue."""
    if xq.device.type == "cpu":
        return qdot_int8_reference(xq, xs, wq, ws, bias)
    _check_rows("qdot_int8", xq, (torch.int8,))
    _check_weight("qdot_int8", xq, wq, ws, bias)
    if (xs.dtype != torch.float32 or xs.numel() != xq.numel() // xq.shape[-1]
            or not xs.is_contiguous() or xs.device != xq.device):
        raise ValueError("qdot_int8: xs must be contiguous float32 (..., 1) on "
                         "the rows' device")
    return _gemm(qdot_int8, xq, xs, wq, ws, None, bias, 1.0)


def qdot(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float (..., K) × int8 (K, N) → f32 (..., N) with dynamic per-row
    activation quantization (+ bias): :func:`row_quant`, then
    :func:`qdot_int8`."""
    return qdot_int8(*row_quant(x), wq, ws, bias)


def qdot_u8(x_u8: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
            corr: torch.Tensor, denom: float = 255.0,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (..., K) × int8 (K, N) → f32 ``(x / denom) @ dequant(wq)``
    (+ bias) with no activation error: the pixels are shifted to int8 as the
    kernel loads them, and the shift's correction and ``/ denom`` sit in its
    epilogue."""
    if x_u8.device.type == "cpu":
        return qdot_u8_reference(x_u8, wq, ws, corr, denom, bias)
    _check_rows("qdot_u8", x_u8, (torch.uint8,))
    n = _check_weight("qdot_u8", x_u8, wq, ws, bias)
    if (corr.dtype != torch.int32 or corr.numel() != n or not corr.is_contiguous()
            or corr.device != x_u8.device):
        raise ValueError("qdot_u8: corr must be contiguous int32 (N,) on the "
                         "rows' device")
    return _gemm(qdot_u8, x_u8, None, wq, ws, corr, bias, denom)


row_quant.launches = 0
qdot_int8.launches = 0
qdot_u8.launches = 0
