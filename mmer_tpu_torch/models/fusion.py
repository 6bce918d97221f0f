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
classifier hidden layer.  The masks are JAX's: flax's ``Dropout`` draws
``bernoulli(make_rng("dropout"), keep, shape)`` with the site's key the
step's dropout key folded with the SHA-1 of its module path and counter
(``fusion/Dropout_0``, ``fusion/layer_i/self_attn/Dropout_0``,
``fusion/layer_i/Dropout_0..2``, ``classifier/Dropout_0..1``;
:func:`dropout_draws`), and the trainer draws a step's masks in one kernel
launch (``train/keys.py``).  ``forward(..., masks=DropoutMasks(...))``
applies them in the forward's order, as flax does: ``select(mask, x /
keep, 0)``, where XLA divides a float32 site by multiplying with the
float32 reciprocal of ``keep`` and a bfloat16 site by dividing by
bfloat16 ``keep`` (:func:`dropout_scales`).  Under ``torch.vmap`` (seed
batches) each lane takes its own seed's masks.

Several models of one config run as one program through
:func:`stack_members` and :func:`member_forward` under ``torch.vmap``: the
serving ensemble, the ensemble evaluations and the seed-batched trainer.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from mmer_tpu_torch.config import ModelConfig, torch_dtype
from mmer_tpu_torch.models import jax_init
from mmer_tpu_torch.models.convert import fusion_from_flax
from mmer_tpu_torch.models.layers import LayerNorm, dense
from mmer_tpu_torch.ops import prng
from mmer_tpu_torch.ops.masked_ops import (attention_bias_from_pad_mask,
                                           masked_mean_pool)
from mmer_tpu_torch.parallel.sharding import (copy_to_model, reduce_from_model,
                                              sum_over_data)


class DropoutMasks:
    """A training forward's masks (:func:`dropout_draws`, drawn ahead of it)
    with their sites' scales (:func:`dropout_scales`), handed out in order
    to the dropout sites that ask for them."""

    def __init__(self, masks: Sequence[torch.Tensor], scales: Sequence):
        self._items = iter(zip(masks, scales))

    def next(self):
        return next(self._items)


def dropout(x: torch.Tensor, rate: float, training: bool,
            masks: Optional[DropoutMasks] = None) -> torch.Tensor:
    """flax ``Dropout``: in training, ``select(mask, x / keep, 0)`` with
    the next of ``masks`` (a 0 / 1 keep mask in ``x``'s dtype and its
    site's scale: a float to multiply a float32 ``x`` by, or a 0-dim tensor
    to divide a bfloat16 ``x`` by); else the identity."""
    if not training or rate <= 0.0:
        return x
    if masks is None:
        raise ValueError("a training forward with dropout on takes the step's "
                         "masks: forward(..., masks=DropoutMasks(...))")
    mask, scale = masks.next()
    return (x * scale if isinstance(scale, float) else x / scale) * mask


class Site(NamedTuple):
    """A dropout site of the training forward: its mask's kind ("attn"
    (b, h, s, s) probabilities, "ffn" (b, s, ffn_dim) inner activations,
    "rows" the rest), shape, rate, flax module path and the dtype it is
    applied in."""
    kind: str
    shape: tuple
    rate: float
    path: tuple
    dtype: torch.dtype


def _dropout_sites(cfg: ModelConfig, b: int, t: int) -> List[Site]:
    """Every dropout site a training forward of a (b, t) batch applies, in
    the order it applies them; sites at rate 0 draw nothing."""
    s, f, h = t + 1, cfg.fused_dim, cfg.fusion_heads
    hidden = cfg.classifier_hidden_dim or cfg.fused_dim // 2
    r, fp32 = cfg.fusion_dropout, torch.float32
    sites = [Site("rows", (b, s, f), r, ("fusion", "Dropout_0"), fp32)]
    for i in range(cfg.fusion_layers):
        layer = ("fusion", f"layer_{i}")
        sites += [Site("attn", (b, h, s, s), r, layer + ("self_attn", "Dropout_0"), fp32),
                  Site("rows", (b, s, f), r, layer + ("Dropout_0",), fp32),
                  Site("ffn", (b, s, cfg.fusion_ffn_dim), r, layer + ("Dropout_1",),
                       torch_dtype(cfg)),
                  Site("rows", (b, s, f), r, layer + ("Dropout_2",), fp32)]
    sites += [Site("rows", (b, hidden), cfg.classifier_dropout,
                   ("classifier", f"Dropout_{i}"), fp32) for i in range(2)]
    return [site for site in sites if site.rate > 0.0]


def dropout_draws(cfg: ModelConfig, b: int, t: int) -> List[prng.Draw]:
    """The draws of a training forward's masks for a (b, t) batch, in the
    order it applies them: each site's key is the step's dropout key folded
    with flax's word for its path and its scope's first ``make_rng``
    (``prng.path_word``), its mask ``uniform < float32(1 - rate)`` in the
    site's dtype."""
    return [prng.Draw((prng.path_word(site.path + (1,)),), site.shape, "mask",
                      1.0 - site.rate, site.dtype)
            for site in _dropout_sites(cfg, b, t)]


def dropout_scales(cfg: ModelConfig, device: torch.device | str) -> list:
    """Each site's scale, in :func:`dropout_draws`' order: XLA turns a
    float32 ``x / keep`` into ``x * float32(1 / float32(keep))`` (a float);
    a bfloat16 one stays a division, in float32, by bfloat16 ``keep`` (a
    0-dim tensor on ``device``: a true division, where a Python divisor
    would be a multiply by its reciprocal on CUDA)."""
    out = []
    for site in _dropout_sites(cfg, 1, 0):
        keep = 1.0 - site.rate
        out.append(float(np.float32(1.0) / np.float32(keep))
                   if site.dtype == torch.float32
                   else torch.tensor(keep, dtype=site.dtype, device=device))
    return out


def shard_dropout_masks(cfg: ModelConfig, masks: Sequence[torch.Tensor],
                        rows: slice, mesh) -> List[torch.Tensor]:
    """A mesh rank's part of masks drawn for the global batch at full width
    (:func:`dropout_draws`): its ``rows`` of every mask, and on a model
    axis its heads of each (b, h, s, s) attention-probability mask and its
    columns of each (b, s, ffn_dim) FFN mask.  So a sharded step applies the
    single-device step's masks."""
    out = []
    split = mesh is not None and mesh.mp > 1
    kinds = [site.kind for site in _dropout_sites(cfg, 1, 0)]
    for kind, mask in zip(kinds, masks):
        mask = mask[rows]
        if split and kind == "attn":
            mask = mask[:, mesh.model_cols(cfg.fusion_heads)]
        elif split and kind == "ffn":
            mask = mask[..., mesh.model_cols(cfg.fusion_ffn_dim)]
        out.append(mask)
    return out


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(dtype=float32)`` over (rows, features), which
    differs from ``torch.nn.BatchNorm1d``'s defaults: momentum 0.99 in flax's
    sense (running = 0.99 * running + 0.01 * batch), eps 1e-5, the batch
    variance ``max(0, E[x²] − E[x]²)`` (biased), and the running variance
    updated with that **biased** variance.  Float32 math and output.

    With ``mesh`` set (``parallel/sharding.py:shard_params``), training
    statistics are the global batch's: the sums of ``x`` and ``x²`` are
    summed over the mesh's data axis, forward and backward, as XLA computes
    them for JAX's batch-sharded step."""

    momentum = 0.99
    eps = 1e-5
    mesh = None

    def __init__(self, dim: int, *, device: torch.device | str):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training and self.mesh is not None:
            n = x.shape[0] * self.mesh.dp
            sums = sum_over_data(torch.stack([x.sum(dim=0), (x * x).sum(dim=0)]),
                                 self.mesh)
            mean = sums[0] / n
            var = (sums[1] / n - mean * mean).clamp_min(0.0)
        elif self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp_min(0.0)
        if self.training:
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


def row_parallel(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype,
                 tp) -> torch.Tensor:
    """:func:`dense` of a row-parallel linear: the partial products summed
    over the model axis in float32, then the bias added once."""
    if tp is None:
        return dense(x, lin, dt)
    y = reduce_from_model(F.linear(x.to(dt), lin.weight.to(dt)).float(), tp)
    return y.to(dt) + lin.bias.to(dt)


class MultiHeadSelfAttention(nn.Module):
    """Masked multi-head self-attention: f32 scores and softmax, GEMM
    operands in the compute dtype.  On a model axis (``tp``, set by
    ``shard_params``) it holds ``num_heads`` of the heads: q, k, v
    column-parallel, the output projection row-parallel."""

    tp = None

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 dropout_rate: float = 0.0, *, device: torch.device | str):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        self.out = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                return_attn: bool = False,
                masks: Optional[DropoutMasks] = None):
        b, s, _ = x.shape
        h = self.num_heads
        hd = self.head_dim
        dt = self.dtype
        x = copy_to_model(x, self.tp)

        def heads(lin):
            return dense(x, lin, dt).reshape(b, s, h, hd).transpose(1, 2).float()

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if attn_bias is not None:
            scores = scores + attn_bias.float()
        probs = dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                        self.training, masks)
        out = torch.matmul(probs.to(dt).float(), v)           # (B, H, S, hd)
        out = row_parallel(out.transpose(1, 2).reshape(b, s, h * hd), self.out,
                           dt, self.tp)
        return out, (probs if return_attn else None)


class PostNormEncoderLayer(nn.Module):
    """``x = LN(x + Drop(SA(x))); x = LN(x + Drop(W2 Drop(relu(W1 x))))``.
    On a model axis (``tp``) W1 is column-parallel and W2 row-parallel."""

    tp = None

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
                masks: Optional[DropoutMasks] = None):
        def drop(t):
            return dropout(t, self.dropout_rate, self.training, masks)

        attn_out, probs = self.self_attn(x, attn_bias, return_attn, masks)
        x = self.norm1(x + drop(attn_out.to(x.dtype)))
        y = row_parallel(drop(torch.relu(dense(copy_to_model(x, self.tp),
                                               self.ffn_in, self.dtype))),
                         self.ffn_out, self.dtype, self.tp)
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
                masks: Optional[DropoutMasks] = None):
        dt = torch_dtype(self.cfg)
        b, t, _ = video_feats.shape
        video = self.norm_video(dense(video_feats, self.video_proj, dt))
        audio = self.norm_audio(dense(audio_feats, self.audio_proj, dt))
        x = torch.cat([video.float(), audio.float()[:, None, :]], dim=1)
        x = dropout(x + self.pos_embed[:, :t + 1], self.cfg.fusion_dropout,
                    self.training, masks)

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
                             masks=masks)
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
                masks: Optional[DropoutMasks] = None) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        x = fused.to(dt)
        for lin, norm in ((self.hidden_0, self.norm_0),
                          (self.hidden_1, self.norm_1)):
            x = dropout(torch.relu(norm(dense(x, lin, dt))),
                        self.cfg.classifier_dropout, self.training,
                        masks).to(dt)
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
                masks: Optional[DropoutMasks] = None):
        fused, attn = self.fusion(video_feats, audio_feats, pad_mask,
                                  return_attn=return_attn, masks=masks)
        logits = self.classifier(fused, masks)
        return torch.softmax(logits, dim=-1), logits, attn


def init_fusion(cfg: ModelConfig, *, device: torch.device | str, seed: int = 0,
                key: Optional[jax_init.Key] = None,
                jitted: bool = False) -> MultimodalEmotionModel:
    """The JAX trainer's initial fusion model for ``seed`` (init key
    ``split(PRNGKey(seed))[1]``; ``key`` replaces it, as the JAX engine's
    seeded head uses ``PRNGKey(0)``), drawn on ``device`` without JAX
    (:mod:`~mmer_tpu_torch.models.jax_init`), in evaluation mode.
    ``jitted``: ``pos_embed`` as a jitted JAX ``init`` rounds it (the JAX
    engine's and ``train_many_seeds``' inits; ``train_model``'s is eager)."""
    model = MultimodalEmotionModel(cfg, device=device)
    model.load_state_dict(fusion_from_flax(jax_init.fusion_tree(
        cfg, seed, device=device, key=key, jitted=jitted)))
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
                   pad_mask=None, masks=None):
    """``base``'s forward with one member's ``params`` and ``buffers``
    (``torch.func.functional_call``): (probs, logits, attn).  Under
    ``torch.vmap`` over the stacked tensors of :func:`stack_members`, one
    lane a member."""
    from torch.func import functional_call

    return functional_call(base, (params, buffers), (video, audio, pad_mask),
                           {"masks": masks})
