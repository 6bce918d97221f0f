"""Wav2Vec2's and WavLM's plain attention as one CUDA kernel.

:func:`plain_attention` computes the plain route of
``EncoderLayer._attention`` (``models/wav2vec2.py``) over q, k, v ``(B, T,
H·D)`` in the compute dtype, as the projections leave them, the ``(B, T)``
pad mask (True on padded frames) and, for WavLM, the gated relative
position bias (the gate ``g`` (B, H, T) and the relative vector ``r`` (H,
2T − 1), ``r[h, d + T − 1] = E[bucket(d), h]``):

    s = (q·kᵀ in float32) / √D
    s += g[b, h, i] · r[h, j − i + T − 1]          (WavLM, float32)
    s += −1e9 on padded keys (float32)
    P = softmax(s) in float32, rounded to the compute dtype
    o = P·v in float32

for each row and head.  A row whose keys are all padded comes out as the
uniform average its finite −1e9 gives, never NaN.

On a CPU tensor it runs :func:`plain_attention_reference`, the torch ops
the encoder has always run there (and runs with ``use_kernels=False``), the
gated bias expanded to its (H, T, T) table (:func:`relative_table`); its
output is ``(B, T, H·D)`` float32.  On a CUDA tensor it launches
``csrc/plain_attention.cu`` once, gated or not, and returns the output
rounded once to bf16, the rounding the ``out`` projection's operand takes
(``layers.dense`` casts to the compute dtype).  The JAX package has no
Pallas kernel here: XLA compiles its ``_xla_attention``
(``mmer_tpu/models/wav2vec2.py:304``).

:func:`tiled_plain_attention_reference` repeats the kernel's order of
operations in plain PyTorch, so that the design is held against the torch
route and the JAX function where there is no GPU.

On CUDA the kernel takes head dim 64 and a bf16 compute dtype:
:func:`plain_attention_limits` names the first of these a config breaks.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mmer_tpu_torch.config import compute_dtype_limit
from mmer_tpu_torch.ops import _build
from mmer_tpu_torch.ops.flash_attention import KEY_BIAS

HEAD_DIM = 64     # the head dim csrc/plain_attention.cu takes
KEY_TILE = 64     # keys per tile of the kernel


def plain_attention_limits(cfg) -> str | None:
    """The first limit of the CUDA plain-attention kernel that ``cfg``
    breaks, as a sentence naming it; None if it breaks none."""
    dtype_limit = compute_dtype_limit(cfg)
    if dtype_limit:
        return dtype_limit
    head_dim = cfg.hidden_dim // cfg.num_heads
    if head_dim != HEAD_DIM:
        return (f"the plain attention kernel takes head dim {HEAD_DIM}, "
                f"got {head_dim}")
    return None


def relative_table(r: torch.Tensor) -> torch.Tensor:
    """The (H, T, T) table ``rel[h, i, j] = r[h, j − i + T − 1]`` of a
    relative vector ``r`` (H, 2T − 1): a gather, so its values are r's."""
    t = (r.shape[1] + 1) // 2
    pos = torch.arange(t, device=r.device)
    return r[:, pos[None, :] - pos[:, None] + (t - 1)]


def table_form(gated: Optional[tuple]) -> Optional[tuple]:
    """The kernel's gated term (gate (B, H, T), r (H, 2T − 1)) in the form
    :func:`plain_attention_reference` takes: (gate (B, H, T, 1), table (H,
    T, T)); None for None."""
    if gated is None:
        return None
    gate, r = gated
    return gate.unsqueeze(-1), relative_table(r)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def plain_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              pad_mask: Optional[torch.Tensor], num_heads: int,
                              gated: Optional[tuple] = None,
                              p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain route in torch ops (the JAX ``_xla_attention``) over q, k,
    v ``(B, T, H·D)`` in the compute dtype: float32 scores, −1e9 on padded
    keys, float32 softmax, probabilities rounded to the compute dtype,
    float32 output ``(B, T, H·D)``.  ``gated`` = (gate (B, H, T, 1), table
    (H, T, T)) adds their product to the scores in place, before the key
    mask (WavLM).  ``p_dtype``: the compute dtype where q, k, v come in
    float32 already (the encoder's torch route converts them first, so that
    it holds no copy in the compute dtype); q's dtype if None."""
    b, t, d = q.shape
    dt = p_dtype or q.dtype
    q, k, v = (_heads(y, num_heads).float() for y in (q, k, v))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // num_heads)
    if gated is not None:
        scores.addcmul_(*gated)
    if pad_mask is not None:
        scores = scores + pad_mask[:, None, None, :].float() * KEY_BIAS
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(dt).float(), v)          # (B, H, T, D)
    return out.transpose(1, 2).reshape(b, t, d)


def tiled_plain_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor,
                                    pad_mask: Optional[torch.Tensor],
                                    num_heads: int,
                                    gated: Optional[tuple] = None,
                                    key_tile: int = KEY_TILE) -> torch.Tensor:
    """The CUDA kernel's order of operations over q, k, v ``(B, T, H·D)``,
    in plain PyTorch; returns ``(B, T, H·D)`` rounded once to q's dtype.
    ``gated``: the kernel's (gate (B, H, T), r (H, 2T − 1)), or None.

    A row's key tiles of ``key_tile`` keys are marked from the mask; tiles
    whose keys are all padded are left out when the row has a valid key
    (their probabilities are exactly 0), a row with none visits them all.
    Pass 1 runs over the visited tiles with a running float32 max ``m`` and
    sum ``l``, ``l`` rescaled by ``exp(m_old − m_new)`` when the max grows;
    pass 2 multiplies each tile's scores again, forms ``exp(s − m) · (1 /
    l)``, rounds it to v's dtype and adds ``P · v`` in float32.  Keys past
    T do not exist in the ragged last tile, and −1e9 goes onto the scores
    of padded keys in the tiles that hold one.  Both passes first add the
    gated term to each tile's scores: ``g · r`` rounded, then the sum."""
    b, t, d = q.shape
    hd = d // num_heads
    scale = 1.0 / math.sqrt(hd)
    qh, kh, vh = (_heads(y, num_heads).float() for y in (q, k, v))
    gate, table = (None, None) if gated is None else (gated[0].float().cpu(),
                                                      relative_table(gated[1].float().cpu()))
    out = torch.empty(b, num_heads, t, hd)
    for bi in range(b):
        padded = (torch.zeros(t, dtype=torch.bool) if pad_mask is None
                  else pad_mask[bi].cpu())
        tiles = [(k0, min(k0 + key_tile, t)) for k0 in range(0, t, key_tile)]
        any_valid = bool((~padded).any())
        visit = [(k0, k1) for k0, k1 in tiles
                 if not any_valid or bool((~padded[k0:k1]).any())]

        def scores(k0, k1):
            s = torch.matmul(qh[bi], kh[bi, :, k0:k1].transpose(-1, -2)) * scale
            if gate is not None:
                s = s + gate[bi][:, :, None] * table[:, :, k0:k1]
            if bool(padded[k0:k1].any()):
                s = s + padded[k0:k1].float() * KEY_BIAS
            return s

        m = torch.full((num_heads, t, 1), float("-inf"))
        l = torch.zeros(num_heads, t, 1)
        for k0, k1 in visit:
            s = scores(k0, k1)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(dim=-1, keepdim=True)
            m = m_new
        inv_l = 1.0 / l
        o = torch.zeros(num_heads, t, hd)
        for k0, k1 in visit:
            p = (torch.exp(scores(k0, k1) - m) * inv_l).to(v.dtype).float()
            o = o + torch.matmul(p, vh[bi, :, k0:k1])
        out[bi] = o
    return out.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pad_mask: Optional[torch.Tensor], num_heads: int) -> int:
    """Raise on what the kernel does not take; return the shared row stride."""
    name = "plain_attention"
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, T, H·D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, d = q.shape
    if num_heads < 1 or d != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM}, got "
                         f"{d} channels in {num_heads} heads")
    ld = q.stride(1)
    for x in (q, k, v):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
        if x.stride() != (t * ld, ld, 1) or ld % 8 or x.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must share one row stride (a "
                             f"multiple of 8) with contiguous 16-byte-aligned rows, "
                             f"got strides {q.stride()}, {k.stride()}, {v.stride()}")
    if pad_mask is not None and (pad_mask.dtype != torch.bool
                                 or tuple(pad_mask.shape) != (b, t)
                                 or pad_mask.device != q.device):
        raise ValueError(f"{name}: pad_mask must be (B, T) bool on q's device, got "
                         f"{pad_mask.dtype} {tuple(pad_mask.shape)}")
    return ld


def _check_gated(gated: tuple, q: torch.Tensor, num_heads: int) -> None:
    """Raise unless ``gated`` is (gate (B, H, T), r (H, 2T − 1)), float32,
    contiguous, on q's device."""
    b, t, _ = q.shape
    shapes = ((b, num_heads, t), (num_heads, 2 * t - 1))
    if len(gated) != 2 or any(
            x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous()
            or x.device != q.device for x, shape in zip(gated, shapes)):
        raise ValueError(f"plain_attention: gated must be (gate {shapes[0]}, r "
                         f"{shapes[1]}), float32 and contiguous on q's device, got "
                         + ", ".join(f"{x.dtype} {tuple(x.shape)}" for x in gated))


# mmer_plain_attention(q, k, v, mask, gate, rel, out, b, heads, t_len, ld, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor], num_heads: int,
                    gated: Optional[tuple] = None) -> torch.Tensor:
    """The plain route (module docstring) over q, k, v ``(B, T, H·D)`` in
    the compute dtype; ``pad_mask`` ``(B, T)`` bool, True on padded frames,
    or None; ``gated`` WavLM's (gate (B, H, T), r (H, 2T − 1)) float32, or
    None.  On the CPU :func:`plain_attention_reference` (float32 out, the
    gated term as its table); on CUDA one launch of the kernel, which takes
    bf16 q, k, v of head dim 64 sharing one row stride (the fused
    projection's column slices too) and raises on anything else, and returns
    ``(B, T, H·D)`` bf16."""
    if q.device.type == "cpu":
        return plain_attention_reference(q, k, v, pad_mask, num_heads, table_form(gated))
    if q.device.type != "cuda":
        raise ValueError(f"plain_attention: unsupported device {q.device}")
    ld = _check(q, k, v, pad_mask, num_heads)
    gate = rel = None
    if gated is not None:
        _check_gated(gated, q, num_heads)
        gate, rel = gated
    b, t, d = q.shape
    mask = None if pad_mask is None else pad_mask.contiguous()
    out = torch.empty(b, t, d, dtype=torch.bfloat16, device=q.device)
    _build.call("plain_attention", "mmer_plain_attention", _ARGTYPES,
                _build.ptr(q), _build.ptr(k), _build.ptr(v),
                None if mask is None else _build.ptr(mask),
                None if gate is None else _build.ptr(gate),
                None if rel is None else _build.ptr(rel), _build.ptr(out),
                b, num_heads, t, ld, _build.stream_ptr(q.device))
    plain_attention.launches += 1
    return out


plain_attention.launches = 0
