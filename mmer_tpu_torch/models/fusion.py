"""CrossModalFusion + EmotionClassifier, the port of ``mmer_tpu/models/fusion.py``.

video (B, T, 768) → Linear(512) → LayerNorm; audio (B, 1024) → Linear(512)
→ LayerNorm → one token; a learned positional embedding; post-norm
transformer layers (``nn.TransformerEncoderLayer(norm_first=False)``
semantics, ReLU FFN) with a key-padding mask in which the audio token is
never masked; masked mean pooling, an output LayerNorm, and a
512→512→512→6 MLP head.  ``forward`` returns (probs, logits, attn), where
``attn`` is the last layer's real attention probabilities when
``return_attn`` is set.

Only the layer-norm (v2) variant is ported; ``norm="batchnorm"`` (v1)
comes with the trainer.  GEMMs run in the compute dtype over float32
params, LayerNorms (eps 1e-6) and the residual stream in float32.  The
model runs at inference only: dropout is not applied.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmer_tpu_torch.config import ModelConfig, torch_dtype
from mmer_tpu_torch.models.layers import LayerNorm, dense, init_like_flax
from mmer_tpu_torch.ops.masked_ops import (attention_bias_from_pad_mask,
                                           masked_mean_pool)


class TokenNorm(nn.Module):
    """The v2 token LayerNorm; the v1 BatchNorm variant is not ported."""

    def __init__(self, kind: str, dim: int, *, device: torch.device | str):
        super().__init__()
        if kind == "batchnorm":
            raise NotImplementedError(
                "TokenNorm: the v1 batchnorm variant comes with the trainer")
        if kind != "layernorm":
            raise ValueError(f"unknown norm kind {kind}")
        self.ln = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x)


class MultiHeadSelfAttention(nn.Module):
    """Masked multi-head self-attention: f32 scores and softmax, GEMM
    operands in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, *,
                 device: torch.device | str):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                return_attn: bool = False):
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h
        dt = self.dtype

        def heads(lin):
            return dense(x, lin, dt).reshape(b, s, h, hd).transpose(1, 2).float()

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if attn_bias is not None:
            scores = scores + attn_bias.float()
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs.to(dt).float(), v)           # (B, H, S, hd)
        out = dense(out.transpose(1, 2).reshape(b, s, d), self.out, dt)
        return out, (probs if return_attn else None)


class PostNormEncoderLayer(nn.Module):
    """``x = LN(x + SA(x)); x = LN(x + W2 relu(W1 x))``."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype, *, device: torch.device | str):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadSelfAttention(dim, num_heads, dtype,
                                                device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.ffn_in = nn.Linear(dim, ffn_dim, device=device)
        self.ffn_out = nn.Linear(ffn_dim, dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)

    def forward(self, x, attn_bias=None, return_attn: bool = False):
        attn_out, probs = self.self_attn(x, attn_bias, return_attn)
        x = self.norm1(x + attn_out.to(x.dtype))
        y = dense(torch.relu(dense(x, self.ffn_in, self.dtype)),
                    self.ffn_out, self.dtype)
        x = self.norm2(x + y.to(x.dtype))
        return x, probs


class CrossModalFusion(nn.Module):
    """Fuse a video token sequence with a single audio token."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        dt, f = torch_dtype(cfg), cfg.fused_dim
        self.video_proj = nn.Linear(cfg.video_dim, f, device=device)
        self.norm_video = TokenNorm(cfg.norm, f, device=device)
        self.audio_proj = nn.Linear(cfg.audio_dim, f, device=device)
        self.norm_audio = TokenNorm(cfg.norm, f, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.max_seq_len, f, device=device))
        self.layers = nn.ModuleList(
            PostNormEncoderLayer(f, cfg.fusion_heads, cfg.fusion_ffn_dim, dt,
                                 device=device)
            for _ in range(cfg.fusion_layers))
        self.out_norm = TokenNorm(cfg.norm, f, device=device)

    def forward(self, video_feats, audio_feats, pad_mask=None,
                return_attn: bool = False):
        dt = torch_dtype(self.cfg)
        b, t, _ = video_feats.shape
        video = self.norm_video(dense(video_feats, self.video_proj, dt))
        audio = self.norm_audio(dense(audio_feats, self.audio_proj, dt))
        x = torch.cat([video.float(), audio.float()[:, None, :]], dim=1)
        x = x + self.pos_embed[:, :t + 1]

        # The audio token is never masked (reference train2.py:163-176).
        full_mask = None
        if pad_mask is not None:
            full_mask = torch.cat(
                [pad_mask, torch.zeros(b, 1, dtype=torch.bool,
                                       device=pad_mask.device)], dim=1)
        bias = attention_bias_from_pad_mask(full_mask)
        attn_probs = None
        for i, layer in enumerate(self.layers):
            x, probs = layer(x, bias,
                             return_attn=return_attn and i == len(self.layers) - 1)
            if probs is not None:
                attn_probs = probs
        return self.out_norm(masked_mean_pool(x, full_mask)), attn_probs


class EmotionClassifier(nn.Module):
    """MLP head: (Linear → Norm → ReLU) × 2 → Linear(num_classes) in f32."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.classifier_hidden_dim or cfg.fused_dim // 2
        self.hidden_0 = nn.Linear(cfg.fused_dim, hidden, device=device)
        self.norm_0 = TokenNorm(cfg.norm, hidden, device=device)
        self.hidden_1 = nn.Linear(hidden, hidden, device=device)
        self.norm_1 = TokenNorm(cfg.norm, hidden, device=device)
        self.out = nn.Linear(hidden, cfg.num_classes, device=device)

    def forward(self, fused: torch.Tensor) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        x = fused.to(dt)
        for lin, norm in ((self.hidden_0, self.norm_0),
                          (self.hidden_1, self.norm_1)):
            x = torch.relu(norm(dense(x, lin, dt))).to(dt)
        return F.linear(x.float(), self.out.weight, self.out.bias)


class MultimodalEmotionModel(nn.Module):
    """Fusion + classifier; ``forward`` returns (probs, logits, attn)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.fusion = CrossModalFusion(cfg, device=device)
        self.classifier = EmotionClassifier(cfg, device=device)

    def forward(self, video_feats, audio_feats, pad_mask=None,
                return_attn: bool = False):
        fused, attn = self.fusion(video_feats, audio_feats, pad_mask,
                                  return_attn=return_attn)
        logits = self.classifier(fused)
        return torch.softmax(logits, dim=-1), logits, attn


def init_fusion(cfg: ModelConfig, *, device: torch.device | str,
                generator: torch.Generator) -> MultimodalEmotionModel:
    """A seeded fusion model from flax's initializer families (Dense
    ``lecun_normal`` with zero bias, LayerNorm (1, 0), ``pos_embed``
    N(0, 0.02))."""
    model = MultimodalEmotionModel(cfg, device=device)
    init_like_flax(model, generator)
    with torch.no_grad():
        model.fusion.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model.eval()
