"""int8-GEMM Wav2Vec2 encoder forward, the port of
``mmer_tpu/models/wav2vec2_quant.py``.

The transformer's GEMMs in int8 (``ops/quant.py``): the feature projection,
q/k/v (one (d, 3d) table a layer, the three weights concatenated once),
attention-out and both FFN matmuls, with per-token activation scales and
per-output-channel weight scales.  Everything else is the float encoder's
own modules and params: the conv feature encoder (``fused_conv_encoder`` on
the card, the plain version with ``use_kernels=False``), the positional-conv
sublayer on the float32 stream (``pos_conv_residual``, likewise), the
LayerNorms (eps 1e-6,
``rsqrt`` of the biased variance) and every bias.  Attention is float32
products and softmax with the finite −1e9 key bias, as JAX's ``einsum``\\ s:
no kernel computes it there either (TF32 stays off on the card, PyTorch's
default for matmuls).  A WavLM encoder's gated relative position bias is
kept: layer 0's relative vector once a forward, expanded to its (H, T, T)
table, and each layer's gate from its float32 normed stream, added to the
float32 scores before the key bias, as the float encoder's torch route adds
them.

Nothing routes here: ``AudioEmbedder``, the engine and the CLIs have no int8
option, as in the JAX package; the forward is reached from these functions
and ``scripts/probe_int8_w2v2.py``.  The card's numbers are in PERF.md.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from mmer_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder, pool_embeddings
from mmer_tpu_torch.ops.conv_pyramid import conv_encoder_reference, fused_conv_encoder
from mmer_tpu_torch.ops.plain_attention import relative_table
from mmer_tpu_torch.ops.quant import qdot, qdot_reference, quantize_weight

LN_EPS = 1e-6
KEY_BIAS = -1e9


def quantize_w2v2_params(model: Wav2Vec2Encoder) -> dict:
    """The float encoder → the int8 side table of the JAX function of this
    name (same keys).  The conv encoder, the positional conv, the
    LayerNorms and the biases (but q/k/v's, concatenated here) stay in the
    model."""
    q: dict = {"layers": []}
    q["proj_q"], q["proj_s"] = quantize_weight(model.proj.weight.t())
    for layer in model.layers:
        lins = (layer.q, layer.k, layer.v)
        ql: dict = {}
        ql["qkv_q"], ql["qkv_s"] = quantize_weight(
            torch.cat([lin.weight for lin in lins]).t())
        ql["qkv_b"] = torch.cat([lin.bias for lin in lins]).detach().float()
        for key, lin in (("out", layer.out), ("fi", layer.ffn_in),
                         ("fo", layer.ffn_out)):
            ql[f"{key}_q"], ql[f"{key}_s"] = quantize_weight(lin.weight.t())
        q["layers"].append(ql)
    return q


def _layernorm(x: torch.Tensor, norm) -> torch.Tensor:
    """JAX's ``(x - mu) * rsqrt(var + 1e-6) * scale + bias`` in float32 with
    the biased two-pass variance; the root through float64 (ROADMAP C)."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((var + LN_EPS).double()).float()
    return (x - mu) * inv * norm.weight + norm.bias


def quant_w2v2_apply(qparams: dict, model: Wav2Vec2Encoder, wave: torch.Tensor,
                     frame_pad_mask: Optional[torch.Tensor] = None, *,
                     use_kernels: bool = True) -> torch.Tensor:
    """Waveform (B, T) → per-frame hidden states (B, T', d) float32, int8
    GEMMs, on ``model``'s float params (its config, conv stack, positional
    conv, norms and biases).

    The JAX forward step for step (stable-layer-norm: pre-norm layers,
    padded frames zeroed before the positional conv, the −1e9 finite key
    bias, final LayerNorm), with a WavLM encoder's gated position bias.
    ``use_kernels`` runs the int8 products through ``csrc/qdot.cu`` (on a
    CUDA tensor), the conv stack through ``fused_conv_encoder`` on the route
    of ``model``'s conv encoder (the default, ``mega``, is JAX's
    ``use_pyramid=True``) and the positional conv through
    ``pos_conv_residual``; ``False`` runs the plain versions of all three."""
    cfg = model.cfg
    h, d = cfg.num_heads, cfg.hidden_dim
    hd = d // h
    dot = qdot if use_kernels else qdot_reference
    conv_args = model.feature_encoder.conv_params()
    if use_kernels:
        feats = fused_conv_encoder(wave, *conv_args, cfg,
                                   mega=model.feature_encoder.mega)
    else:
        feats = conv_encoder_reference(wave, *conv_args, cfg)

    x = _layernorm(feats, model.proj_norm)
    x = dot(x, qparams["proj_q"], qparams["proj_s"], model.proj.bias)
    x = model.pos_conv(x, frame_pad_mask, use_kernels)

    mask_bias = None
    if frame_pad_mask is not None:
        mask_bias = frame_pad_mask[:, None, None, :].float() * KEY_BIAS
    root = torch.tensor(math.sqrt(hd), device=x.device)
    b, s = x.shape[0], x.shape[1]
    rel = model.position_bias(s, x.device)
    if rel is not None:
        rel = relative_table(rel)
    for ql, layer in zip(qparams["layers"], model.layers):
        y = _layernorm(x, layer.norm_attn)
        qkv = dot(y, ql["qkv_q"], ql["qkv_s"], ql["qkv_b"])
        qv, kv, vv = (t.reshape(b, s, h, hd).transpose(1, 2)
                      for t in qkv.split(d, dim=-1))
        scores = torch.matmul(qv, kv.transpose(-1, -2)) / root
        if rel is not None:
            scores.addcmul_(layer.position_gate(y).unsqueeze(-1), rel)
        if mask_bias is not None:
            scores = scores + mask_bias
        attn = torch.matmul(torch.softmax(scores, dim=-1), vv)
        attn = attn.transpose(1, 2).reshape(b, s, d)
        x = x + dot(attn, ql["out_q"], ql["out_s"]) + layer.out.bias
        y = _layernorm(x, layer.norm_ffn)
        hdn = F.gelu(dot(y, ql["fi_q"], ql["fi_s"], layer.ffn_in.bias))
        x = x + dot(hdn, ql["fo_q"], ql["fo_s"]) + layer.ffn_out.bias
    return _layernorm(x, model.final_norm)


def quant_w2v2_embed(qparams: dict, model: Wav2Vec2Encoder, wave: torch.Tensor,
                     frame_pad_mask: torch.Tensor, *,
                     use_kernels: bool = True) -> torch.Tensor:
    """:func:`quant_w2v2_apply` with the embedder's masked mean pool and L2
    norm (``AudioEmbedder.embed_rows``): (B, d) float32."""
    hidden = quant_w2v2_apply(qparams, model, wave, frame_pad_mask,
                              use_kernels=use_kernels)
    return pool_embeddings(hidden, frame_pad_mask)
