"""CrossModalFusion + EmotionClassifier, the port of ``mmer_tpu/models/fusion.py``.

video (B, T, 768) → Linear(512) → LayerNorm; audio (B, 1024) → Linear(512)
→ LayerNorm → one token; a learned positional embedding; post-norm
transformer layers (``nn.TransformerEncoderLayer(norm_first=False)``
semantics, ReLU FFN) with a key-padding mask in which the audio token is
never masked; masked mean pooling, an output LayerNorm, and a
512→512→512→6 MLP head.  ``forward`` returns (probs, logits, attn), where
``attn`` is the last layer's real attention probabilities when
``return_attn`` is set.

``norm="layernorm"`` is the v2 model, ``norm="batchnorm"`` the v1 one, with
flax's BatchNorm semantics (:class:`BatchNorm`).  GEMMs run in the compute
dtype over float32 params; norms and the residual stream are float32.

In training mode (``model.train()``) dropout is applied where the JAX model
applies it: on the attention probabilities, after the attention and FFN
sublayers, inside the FFN, after the positional embedding and after each
classifier hidden layer; ``forward(..., generator=g)`` draws the masks from
an explicit ``torch.Generator`` (on the inputs' device), else from the
global one; ``generator=DropoutMasks(masks)`` applies masks drawn
beforehand (:func:`draw_dropout_masks`) in the order the forward would draw
them, which is how a forward under ``torch.vmap`` (one lane a seed) gets
each seed's own masks.  The JAX and PyTorch random streams differ, so only
the rate and the scaling of the masks can be compared.

Several models of one config run as one program through
:func:`stack_members` and :func:`member_forward` under ``torch.vmap``: the
serving ensemble, the ensemble evaluations and the seed-batched trainer.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmer_tpu_torch.config import ModelConfig, torch_dtype
from mmer_tpu_torch.models.layers import LayerNorm, dense, init_like_flax
from mmer_tpu_torch.ops.masked_ops import (attention_bias_from_pad_mask,
                                           masked_mean_pool)


class DropoutMasks:
    """Masks drawn ahead of a forward (:func:`draw_dropout_masks`), handed
    out in order to the dropout sites that ask for them."""

    def __init__(self, masks: Sequence[torch.Tensor]):
        self._masks = iter(masks)

    def next(self) -> torch.Tensor:
        return next(self._masks)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator=None) -> torch.Tensor:
    """flax ``Dropout``: in training, zero each element with probability
    ``rate`` and scale the rest by ``1 / (1 - rate)``; else the identity.
    ``generator``: a ``torch.Generator``, None (the global one) or a
    :class:`DropoutMasks`."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, DropoutMasks):
        mask = generator.next()
    else:
        mask = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        mask.bernoulli_(keep, generator=generator)
    return x * (mask / keep).to(x.dtype)


def dropout_shapes(cfg: ModelConfig, b: int, t: int) -> List[Tuple[tuple, float]]:
    """(shape, rate) of every mask a training forward of a (b, t) batch
    draws, in the order it draws them; sites at rate 0 draw nothing."""
    s, f, h = t + 1, cfg.fused_dim, cfg.fusion_heads
    hidden = cfg.classifier_hidden_dim or cfg.fused_dim // 2
    layer = [(b, h, s, s), (b, s, f), (b, s, cfg.fusion_ffn_dim), (b, s, f)]
    sites = ([((b, s, f), cfg.fusion_dropout)]
             + [(shape, cfg.fusion_dropout)
                for _ in range(cfg.fusion_layers) for shape in layer]
             + [((b, hidden), cfg.classifier_dropout)] * 2)
    return [(shape, rate) for shape, rate in sites if rate > 0.0]


def draw_dropout_masks(cfg: ModelConfig, b: int, t: int,
                       generator: Optional[torch.Generator],
                       out: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Draw into ``out`` (tensors shaped as :func:`dropout_shapes` says) the
    masks a training forward of a (b, t) batch would draw from
    ``generator``: the same order, the same bits."""
    for buf, (_, rate) in zip(out, dropout_shapes(cfg, b, t)):
        buf.bernoulli_(1.0 - rate, generator=generator)
    return out


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(dtype=float32)`` over (rows, features), which
    differs from ``torch.nn.BatchNorm1d``'s defaults: momentum 0.99 in flax's
    sense (running = 0.99 * running + 0.01 * batch), eps 1e-5, the batch
    variance ``max(0, E[x²] − E[x]²)`` (biased), and the running variance
    updated with that **biased** variance.  Float32 math and output."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, dim: int, *, device: torch.device | str):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(
                    var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class TokenNorm(nn.Module):
    """LayerNorm (v2) or feature BatchNorm (v1, reference train.py:50-51).
    The batch statistics run over all ``(B·T, F)`` rows of a token tensor,
    padded rows included, as in the JAX model."""

    def __init__(self, kind: str, dim: int, *, device: torch.device | str):
        super().__init__()
        if kind not in ("layernorm", "batchnorm"):
            raise ValueError(f"unknown norm kind {kind}")
        self.kind = kind
        if kind == "layernorm":
            self.ln = LayerNorm(dim, device=device)
        else:
            self.bn = BatchNorm(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "layernorm":
            return self.ln(x)
        return self.bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class MultiHeadSelfAttention(nn.Module):
    """Masked multi-head self-attention: f32 scores and softmax, GEMM
    operands in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 dropout_rate: float = 0.0, *, device: torch.device | str):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
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
        probs = dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                        self.training, generator)
        out = torch.matmul(probs.to(dt).float(), v)           # (B, H, S, hd)
        out = dense(out.transpose(1, 2).reshape(b, s, d), self.out, dt)
        return out, (probs if return_attn else None)


class PostNormEncoderLayer(nn.Module):
    """``x = LN(x + Drop(SA(x))); x = LN(x + Drop(W2 Drop(relu(W1 x))))``."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype, dropout_rate: float = 0.0, *,
                 device: torch.device | str):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadSelfAttention(dim, num_heads, dtype,
                                                dropout_rate, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.ffn_in = nn.Linear(dim, ffn_dim, device=device)
        self.ffn_out = nn.Linear(ffn_dim, dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)

    def forward(self, x, attn_bias=None, return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        def drop(t):
            return dropout(t, self.dropout_rate, self.training, generator)

        attn_out, probs = self.self_attn(x, attn_bias, return_attn, generator)
        x = self.norm1(x + drop(attn_out.to(x.dtype)))
        y = dense(drop(torch.relu(dense(x, self.ffn_in, self.dtype))),
                  self.ffn_out, self.dtype)
        x = self.norm2(x + drop(y.to(x.dtype)))
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
                                 cfg.fusion_dropout, device=device)
            for _ in range(cfg.fusion_layers))
        self.out_norm = TokenNorm(cfg.norm, f, device=device)

    def forward(self, video_feats, audio_feats, pad_mask=None,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        dt = torch_dtype(self.cfg)
        b, t, _ = video_feats.shape
        video = self.norm_video(dense(video_feats, self.video_proj, dt))
        audio = self.norm_audio(dense(audio_feats, self.audio_proj, dt))
        x = torch.cat([video.float(), audio.float()[:, None, :]], dim=1)
        x = dropout(x + self.pos_embed[:, :t + 1], self.cfg.fusion_dropout,
                    self.training, generator)

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
                             return_attn=return_attn and i == len(self.layers) - 1,
                             generator=generator)
            if probs is not None:
                attn_probs = probs
        return self.out_norm(masked_mean_pool(x, full_mask)), attn_probs


class EmotionClassifier(nn.Module):
    """MLP head: (Linear → Norm → ReLU → Dropout) × 2 → Linear(num_classes)
    in f32."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.classifier_hidden_dim or cfg.fused_dim // 2
        self.hidden_0 = nn.Linear(cfg.fused_dim, hidden, device=device)
        self.norm_0 = TokenNorm(cfg.norm, hidden, device=device)
        self.hidden_1 = nn.Linear(hidden, hidden, device=device)
        self.norm_1 = TokenNorm(cfg.norm, hidden, device=device)
        self.out = nn.Linear(hidden, cfg.num_classes, device=device)

    def forward(self, fused: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        x = fused.to(dt)
        for lin, norm in ((self.hidden_0, self.norm_0),
                          (self.hidden_1, self.norm_1)):
            x = dropout(torch.relu(norm(dense(x, lin, dt))),
                        self.cfg.classifier_dropout, self.training,
                        generator).to(dt)
        return F.linear(x.float(), self.out.weight, self.out.bias)


class MultimodalEmotionModel(nn.Module):
    """Fusion + classifier; ``forward`` returns (probs, logits, attn).  The
    model is built in evaluation mode (no dropout, running batch statistics),
    the JAX model's ``train=False`` default; the trainer calls ``.train()``."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        self.fusion = CrossModalFusion(cfg, device=device)
        self.classifier = EmotionClassifier(cfg, device=device)
        self.eval()

    def forward(self, video_feats, audio_feats, pad_mask=None,
                return_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        fused, attn = self.fusion(video_feats, audio_feats, pad_mask,
                                  return_attn=return_attn, generator=generator)
        logits = self.classifier(fused, generator)
        return torch.softmax(logits, dim=-1), logits, attn


def init_fusion(cfg: ModelConfig, *, device: torch.device | str,
                generator: torch.Generator) -> MultimodalEmotionModel:
    """A seeded fusion model from flax's initializer families (Dense
    ``lecun_normal`` with zero bias, norms (1, 0) with running statistics
    (0, 1), ``pos_embed`` N(0, 0.02)), in evaluation mode."""
    model = MultimodalEmotionModel(cfg, device=device)
    init_like_flax(model, generator)
    with torch.no_grad():
        model.fusion.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model.eval()


def stack_members(members: Sequence[nn.Module]
                  ) -> Tuple[nn.Module, Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """Fusion models of one config → (a skeleton on the meta device, their
    parameters and buffers stacked along a new leading member axis).  The
    stacked parameters are new leaves that require grad."""
    from torch.func import stack_module_state

    params, buffers = stack_module_state(list(members))
    return copy.deepcopy(members[0]).to("meta"), params, buffers


def member_forward(base: nn.Module, params: Dict[str, torch.Tensor],
                   buffers: Dict[str, torch.Tensor], video, audio,
                   pad_mask=None, generator=None):
    """``base``'s forward with one member's ``params`` and ``buffers``
    (``torch.func.functional_call``): (probs, logits, attn).  Under
    ``torch.vmap`` over the stacked tensors of :func:`stack_members`, one
    lane a member."""
    from torch.func import functional_call

    return functional_call(base, (params, buffers), (video, audio, pad_mask),
                           {"generator": generator})
