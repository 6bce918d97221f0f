"""int8-GEMM ViViT forward, the port of ``mmer_tpu/models/vivit_quant.py``.

The same embedding function as :class:`~mmer_tpu_torch.models.vivit.
ViViTFeatureExtractor` (the JAX package's fixed random projection, one
seeded init) with its GEMMs in int8 (``ops/quant.py``): the tubelet
projection on the uint8 pixel path (no activation error), q/k/v,
attention-out and both FFN GEMMs with per-token activation scales and
per-output-channel weight scales.  LayerNorm (eps 1e-6, the biased
variance), the exact-erf GELU, softmax and the float32 residual stream stay
in float; q, k and v are rounded to bf16 for attention, as in JAX.

The int8 tables come from the float model once (:func:`quantize_vivit_params`),
so the seeded weights stay the one source.  Nothing routes here: the
extractors, the engine and the CLIs have no int8 option, as in the JAX
package (which removed its ``precision=`` hooks after measuring this path
slower on its TPU); the forward is reached from this function and
``scripts/probe_int8_vivit.py``.  The card's numbers are in PERF.md.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.models.vivit import ViViTFeatureExtractor, tubelets
from mmer_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from mmer_tpu_torch.ops.quant import (qdot, qdot_reference, qdot_u8,
                                      qdot_u8_reference, quantize_weight,
                                      u8_correction)

LN_EPS = 1e-6


def quantize_vivit_params(model: ViViTFeatureExtractor) -> dict:
    """The float model → the int8 side table of the JAX function of this
    name (same keys): int8 weights with their scales, the pixel path's
    correction, and the float params the forward reads."""
    def f32(t):
        return None if t is None else t.detach().float()

    proj = model.embed.proj
    q: dict = {"blocks": []}
    q["proj_q"], q["proj_s"] = quantize_weight(proj.weight.t())
    q["proj_corr"] = u8_correction(q["proj_q"])
    q["proj_b"] = f32(proj.bias)
    q["cls"] = f32(model.cls_token)
    q["pos"] = f32(model.pos_embed)
    for blk in model.blocks:
        qb = {"ln1_s": f32(blk.norm1.weight), "ln1_b": f32(blk.norm1.bias),
              "ln2_s": f32(blk.norm2.weight), "ln2_b": f32(blk.norm2.bias),
              "ffn_in_b": f32(blk.ffn_in.bias),
              "ffn_out_b": f32(blk.ffn_out.bias)}
        for key, lin in (("qkv", blk.to_qkv), ("out", blk.to_out),
                         ("fi", blk.ffn_in), ("fo", blk.ffn_out)):
            qb[f"{key}_q"], qb[f"{key}_s"] = quantize_weight(lin.weight.t())
        q["blocks"].append(qb)
    return q


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """JAX's ``(x - m) / sqrt(var + 1e-6) * scale + bias`` with the biased
    two-pass variance; the root through float64 (PyTorch's CPU float32
    ``sqrt`` is unreliable, ROADMAP C), which rounds as float32's does."""
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    root = torch.sqrt((v + LN_EPS).double()).float()
    return (x - m) / root * scale + bias


def quant_vivit_apply(qparams: dict, video_u8: torch.Tensor,
                      cfg: Optional[ViViTConfig] = None, *,
                      use_kernels: bool = True,
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """(B, F, H, W, C) uint8 → (B, dim) float32 features, int8 GEMMs.

    The JAX forward step for step: tubelet patchify (the float model's token
    order) → CLS and positional embedding → pre-norm blocks → CLS pool.
    ``use_kernels`` runs the int8 products through ``csrc/qdot.cu`` (on a
    CUDA tensor) and attention through ``flash_attention``; ``False`` runs
    the plain versions of both.  ``use_flash=None`` follows ``use_kernels``;
    ``False`` keeps the int8 kernels with plain attention (JAX's
    ``use_flash=False``)."""
    cfg = cfg or ViViTConfig()
    flash = use_kernels if use_flash is None else use_flash
    dot = qdot if use_kernels else qdot_reference
    dot_u8 = qdot_u8 if use_kernels else qdot_u8_reference
    attend = flash_attention if flash else reference_attention

    x = dot_u8(tubelets(video_u8, cfg), qparams["proj_q"], qparams["proj_s"],
               qparams["proj_corr"], bias=qparams["proj_b"])
    b = x.shape[0]
    if cfg.pool == "cls":
        cls = qparams["cls"].expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
    n = x.shape[1]
    x = x + qparams["pos"][:, :n]

    heads, hd = cfg.heads, cfg.dim_head

    def heads_first(z):
        return z.reshape(b, n, heads, hd).transpose(1, 2).contiguous()

    for qb in qparams["blocks"]:
        y = _layernorm(x, qb["ln1_s"], qb["ln1_b"])
        qkv = dot(y, qb["qkv_q"], qb["qkv_s"]).to(torch.bfloat16)
        qv, kv, vv = (heads_first(t) for t in qkv.chunk(3, dim=-1))
        attn = attend(qv, kv, vv).transpose(1, 2).reshape(b, n, heads * hd)
        x = x + dot(attn, qb["out_q"], qb["out_s"])
        y = _layernorm(x, qb["ln2_s"], qb["ln2_b"])
        h = F.gelu(dot(y, qb["fi_q"], qb["fi_s"], qb["ffn_in_b"]))
        x = x + dot(h, qb["fo_q"], qb["fo_s"]) + qb["ffn_out_b"]

    feats = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    return feats.float()
