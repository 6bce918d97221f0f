"""Wav2Vec2-large (robust variant) audio embedder, the port of
``mmer_tpu/models/wav2vec2.py``.

Waveform (B, L) at 16 kHz → per-frame hidden states (B, T, 1024) →
length-masked mean pool → L2 norm → (1024,):

- feature encoder: seven conv → LayerNorm → GELU layers through
  :func:`~mmer_tpu_torch.ops.conv_pyramid.fused_conv_encoder` (one CUDA
  kernel launch per layer on the card, on either of its two routes);
- feature projection LayerNorm(512) → Linear(1024), float32 stream;
- the positional-conv sublayer (padded frames zeroed, grouped conv of
  kernel 128 in 16 groups with weight norm folded, the trailing frame
  trimmed for the even kernel, GELU, residual) through
  :func:`~mmer_tpu_torch.ops.pos_conv.pos_conv_residual` (one CUDA kernel
  launch on the card);
- 24 stable-layer-norm layers: masked attention with a finite −1e9 key
  bias (a fully masked row comes out uniform, not NaN), plain (f32 scores,
  the f32 softmax normalised before the probabilities are rounded) through
  :func:`~mmer_tpu_torch.ops.plain_attention.plain_attention` (one CUDA
  kernel launch a layer on the card with ``use_kernels``; torch ops on the
  CPU and with ``use_kernels=False``) or, with ``use_flash_attn``, through
  :func:`~mmer_tpu_torch.ops.flash_attention.flash_attention` with one key
  length per clip; q, k and v from three projections or, with
  ``use_fused_qkv``, one product over their weights concatenated on every
  call; the FFN sublayer through
  :func:`~mmer_tpu_torch.ops.fused_blocks.fused_ffn`;
- a final LayerNorm.

A :class:`~mmer_tpu_torch.config.WavLMConfig` builds WavLM on the same
modules: no conv biases (the kernels take zeros made once at build), and a
gated relative position bias in each layer's plain attention.  Layer 0
holds the ``(num_buckets, H)`` embedding ``E``; once a forward the table
``rel[h, q, k] = E[bucket(k - q), h]`` is built and every layer adds
``g[b, h, q] · rel[h, q, k]`` to its float32 scores before the key mask,
``g`` a gate from the query's own normed frame (:meth:`EncoderLayer.position_gate`).
Neither kernel takes such a bias: WavLM's layers run the plain route's
torch ops on every device, and the flash route is refused for it.

Params stay float32; GEMM operands and the FFN biases are rounded to the
compute dtype; the residual stream stays float32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmer_tpu_torch.config import (Wav2Vec2Config, WavLMConfig, compute_dtype_limit,
                                   torch_dtype)
from mmer_tpu_torch.core.buckets import batch_bucket
from mmer_tpu_torch.core.mesh import Mesh, active_mesh, pad_to_multiple
from mmer_tpu_torch.models import jax_init
from mmer_tpu_torch.models.convert import wav2vec2_from_flax, wav2vec2_to_flax
from mmer_tpu_torch.models.layers import (LayerNorm, dense, load_or_save_params,
                                         refuse_kernel_limit)
from mmer_tpu_torch.ops import conv_pyramid
from mmer_tpu_torch.ops.conv_pyramid import (conv_encoder_reference,
                                             fused_conv_encoder, supports_config)
from mmer_tpu_torch.ops.flash_attention import attention_limits, flash_attention
from mmer_tpu_torch.ops.fused_blocks import ffn_limits, ffn_reference, fused_ffn
from mmer_tpu_torch.ops.plain_attention import (plain_attention,
                                                plain_attention_limits,
                                                plain_attention_reference)
from mmer_tpu_torch.ops.pos_conv import (pos_conv_limits, pos_conv_reference,
                                         pos_conv_residual)
from mmer_tpu_torch.utils.profiling import cast, count, span


def feat_extract_output_length(cfg: Wav2Vec2Config, input_length: int) -> int:
    """Conv-stack output length for a waveform length (VALID convs)."""
    length = input_length
    for kernel, stride in zip(cfg.conv_kernels, cfg.conv_strides):
        length = (length - kernel) // stride + 1
    return max(length, 0)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """WavLM's bucket of each relative position ``rel = k - q`` (integer
    tensor): half of ``num_buckets`` a direction, the upper half for
    ``rel > 0``; within a half, ``|rel|`` itself below a quarter of
    ``num_buckets``, from there ``quarter + ⌊ln(|rel| / quarter) /
    ln(max_distance / quarter) · quarter⌋`` in float32, capped at the
    half's last bucket (HF ``WavLMAttention._relative_positions_bucket``)."""
    half = num_buckets // 2
    exact = half // 2
    dist = rel.abs()
    far = (torch.log(dist.clamp_min(1).float() / exact) / math.log(max_distance / exact)
           * (half - exact)).to(torch.long) + exact
    near = dist < exact
    return (rel > 0).long() * half + torch.where(near, dist, far.clamp_max(half - 1))


def position_bias_limit(cfg: Wav2Vec2Config) -> str | None:
    """The flash route's limit on a config with a relative position bias,
    as a sentence; None for a config without one."""
    if isinstance(cfg, WavLMConfig):
        return ("flash attention takes no relative position bias, and WavLM's "
                "gated bias would be dropped; the plain route "
                "(use_flash_attn=False) computes it")
    return None


def kernel_limits(cfg: Wav2Vec2Config, use_kernels: bool = True,
                  use_flash_attn: bool = False, mega: bool = True) -> str | None:
    """The first limit of the CUDA kernels that a Wav2Vec2 config breaks on
    the routes named (with ``use_kernels`` the conv encoder on route
    ``mega``, the FFN, the positional conv and, without ``use_flash_attn``
    and for a config without a position bias, plain attention; with
    ``use_flash_attn`` flash attention), as a sentence naming it; None if it
    breaks none.  The plain path takes any config."""
    limits = []
    if use_kernels:
        limits += [conv_pyramid.kernel_limits(cfg, mega),
                   ffn_limits(cfg.hidden_dim, cfg.ffn_dim), pos_conv_limits(cfg)]
        if not use_flash_attn and not position_bias_limit(cfg):
            limits.append(plain_attention_limits(cfg))
    if use_flash_attn:
        limits += [position_bias_limit(cfg), compute_dtype_limit(cfg),
                   attention_limits(cfg.hidden_dim // cfg.num_heads)]
    return next((limit for limit in limits if limit), None)


class ConvFeatureEncoder(nn.Module):
    """Raw waveform (B, L) → frame features (B, T, conv_dims[-1]).
    ``mega`` picks the route of ``fused_conv_encoder`` (whole-pyramid port or
    the per-layer merged-view kernels).  On a CUDA device with
    ``use_kernels`` a config the kernels do not take is refused here.  A
    config with ``conv_bias`` false (WavLM) has convs without biases, and
    the conv biases passed on are zeros made once here."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str,
                 use_kernels: bool = True, mega: bool = True):
        super().__init__()
        if not supports_config(cfg):
            raise ValueError("ConvFeatureEncoder: only the layer-norm, stride-2 "
                             "k2/k3 conv stacks are ported")
        if use_kernels:
            refuse_kernel_limit("ConvFeatureEncoder", device,
                                conv_pyramid.kernel_limits(cfg, mega))
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.mega = mega
        c_in = 1
        convs, norms = [], []
        bias = getattr(cfg, "conv_bias", True)
        if not bias:
            self.register_buffer("zero_bias", torch.zeros(max(cfg.conv_dims),
                                                          device=device),
                                 persistent=False)
        for dim, k, s in zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides):
            convs.append(nn.Conv1d(c_in, dim, k, stride=s, bias=bias, device=device))
            norms.append(LayerNorm(dim, device=device))
            c_in = dim
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def conv_params(self) -> tuple:
        """(conv weights, conv biases, LN weights, LN biases), the argument
        lists of ``fused_conv_encoder`` and ``conv_encoder_reference``."""
        return ([c.weight for c in self.convs],
                [self.zero_bias[:c.out_channels] if c.bias is None else c.bias
                 for c in self.convs],
                [n.weight for n in self.norms], [n.bias for n in self.norms])

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        args = self.conv_params()
        if not self.use_kernels:
            return conv_encoder_reference(wave, *args, self.cfg)
        return fused_conv_encoder(wave, *args, self.cfg, mega=self.mega)


class PosConvEmbed(nn.Module):
    """The positional conv's params (weight norm folded into the kernel):
    an ``nn.Conv1d`` of ``num_conv_pos_embeddings`` taps in
    ``num_conv_pos_embedding_groups`` groups, whose weight and bias
    ``pos_conv_residual`` takes.  ``forward`` is the whole sublayer."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_dim, cfg.hidden_dim, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups,
                              device=device)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                use_kernels: bool = True) -> torch.Tensor:
        """``x`` (B, T, D) float32 → ``x`` with its padded frames zeroed plus
        the GELU of the conv: through the kernel with ``use_kernels``, else
        the plain version."""
        sublayer = pos_conv_residual if use_kernels else pos_conv_reference
        return sublayer(x, pad_mask, self.conv.weight, self.conv.bias, self.cfg)


class EncoderLayer(nn.Module):
    """Stable-layer-norm transformer layer (pre-norm, biased projections).
    For a :class:`WavLMConfig` it also holds its position gate: a shared
    (8, head_dim) ``gru_rel_pos_linear`` and a per-head ``gru_rel_pos_const``
    (HF ``WavLMAttention``'s names), and with ``rel_embed`` (layer 0) the
    ``(num_buckets, H)`` embedding ``rel_attn_embed`` of the table."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str,
                 use_kernels: bool = True, use_flash_attn: bool = False,
                 use_fused_qkv: bool = False, rel_embed: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.use_flash_attn = use_flash_attn
        self.use_fused_qkv = use_fused_qkv
        d = cfg.hidden_dim
        self.norm_attn = LayerNorm(d, device=device)
        self.q = nn.Linear(d, d, device=device)
        self.k = nn.Linear(d, d, device=device)
        self.v = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)
        self.norm_ffn = LayerNorm(d, device=device)
        self.ffn_in = nn.Linear(d, cfg.ffn_dim, device=device)
        self.ffn_out = nn.Linear(cfg.ffn_dim, d, device=device)
        if isinstance(cfg, WavLMConfig):
            self.gru_rel_pos_linear = nn.Linear(d // cfg.num_heads, 8, device=device)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(cfg.num_heads,
                                                             device=device))
            if rel_embed:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, cfg.num_heads,
                                                   device=device)

    def position_bias(self, t: int, device: torch.device) -> torch.Tensor:
        """Layer 0's ungated table (H, t, t) float32 for ``t`` frames:
        ``rel[h, q, k] = E[bucket(k - q), h]``.  Counts its bytes under
        ``wavlm.bias_bytes``."""
        pos = torch.arange(t, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.cfg.num_buckets,
                                           self.cfg.max_bucket_distance)
        rel = self.rel_attn_embed.weight.t()[:, buckets]
        count("wavlm.bias_bytes", rel.numel() * rel.element_size())
        return rel

    def position_gate(self, y: torch.Tensor) -> torch.Tensor:
        """The gate (B, H, T, 1) float32 of the layer's position bias from
        its normed stream ``y`` (B, T, d) float32: each head's slice through
        ``gru_rel_pos_linear``, its 8 outputs summed in two groups of four,
        ``a, c = σ(·)``, ``g = a · (c · κ_h − 1) + 2``.  Counts the gate's
        bytes under ``wavlm.bias_bytes``."""
        b, t, d = y.shape
        h = self.cfg.num_heads
        p = F.linear(y.reshape(b, t, h, d // h), self.gru_rel_pos_linear.weight,
                     self.gru_rel_pos_linear.bias)
        a, c = torch.sigmoid(p.reshape(b, t, h, 2, 4).sum(-1)).unbind(-1)
        g = a * (c * self.gru_rel_pos_const - 1.0) + 2.0
        count("wavlm.bias_bytes", g.numel() * g.element_size())
        return g.transpose(1, 2).unsqueeze(-1)

    def project_qkv(self, yd: torch.Tensor) -> tuple:
        """q, k, v (B, T, d) in the compute dtype from the normed stream
        ``yd``: three biased projections or, with ``use_fused_qkv``, one
        product in the compute dtype, ``yd @ w + b`` over the (d, 3d) weight
        and (3d,) bias concatenated on every call, as the JAX layer computes
        them (the params keep the three-projection layout)."""
        dt = torch_dtype(self.cfg)
        lins = (self.q, self.k, self.v)
        if not self.use_fused_qkv:
            return tuple(dense(yd, lin, dt) for lin in lins)
        w = cast(torch.cat([lin.weight.t() for lin in lins], dim=1), dt)
        bias = cast(torch.cat([lin.bias for lin in lins]), dt)
        qkv = torch.matmul(yd.to(dt), w) + bias
        return qkv.split(yd.shape[-1], dim=-1)

    def _attention(self, yd: torch.Tensor, pad_mask: Optional[torch.Tensor],
                   gated: Optional[tuple] = None) -> torch.Tensor:
        """Attention over the projected heads (:meth:`project_qkv`).  Plain,
        as the JAX ``_xla_attention``: f32 scores, −1e9 on padded keys, f32
        softmax, probabilities rounded to the compute dtype, f32 sums of
        ``P·v``; with ``use_kernels`` and no ``gated`` term through
        :func:`~mmer_tpu_torch.ops.plain_attention.plain_attention` (one
        CUDA kernel on the card, whose output is rounded to the compute
        dtype, as ``dense`` rounds it next), else the same arithmetic in
        torch ops (f32 output).  ``gated`` = (gate (B, H, T, 1), table (H, T,
        T)) adds their product to the scores in place, before the key mask
        (WavLM; torch ops on every device).  With ``use_flash_attn``: q, k, v
        go to ``flash_attention`` in the compute dtype with one key length
        per clip (frame pads are a suffix, so a count is a complete mask) and
        the output comes back in that dtype."""
        b, t, d = yd.shape
        h = self.cfg.num_heads
        if self.use_flash_attn:
            q, k, v = (y.reshape(b, t, h, d // h).transpose(1, 2).contiguous()
                       for y in self.project_qkv(yd))
            key_lens = None if pad_mask is None else (~pad_mask).sum(1)
            out = flash_attention(q, k, v, key_lens=key_lens)
            return out.transpose(1, 2).reshape(b, t, d)
        if self.use_kernels and gated is None:
            return plain_attention(*self.project_qkv(yd), pad_mask, h)
        q, k, v = (y.float() for y in self.project_qkv(yd))
        return plain_attention_reference(q, k, v, pad_mask, h, gated,
                                         p_dtype=torch_dtype(self.cfg))

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                rel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``rel``: layer 0's table (:meth:`position_bias`) for a WavLM
        layer, which gates it with its own :meth:`position_gate`."""
        dt = torch_dtype(self.cfg)
        y = self.norm_attn(x)
        gated = None if rel is None else (self.position_gate(y), rel)
        attn = self._attention(y.to(dt), pad_mask, gated)
        attn = dense(attn, self.out, dt)
        x = x + attn.to(x.dtype)
        ffn = fused_ffn if self.use_kernels else ffn_reference
        return ffn(x, self.norm_ffn.weight, self.norm_ffn.bias,
                   cast(self.ffn_in.weight, dt), cast(self.ffn_in.bias, dt),
                   cast(self.ffn_out.weight, dt), cast(self.ffn_out.bias, dt))


class Wav2Vec2Encoder(nn.Module):
    """Waveform (B, L) → per-frame hidden states (B, T, hidden_dim) f32."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str,
                 use_kernels: bool = True,
                 use_flash_attn: Optional[bool] = None, mega: bool = True,
                 use_fused_qkv: bool = False):
        """``use_flash_attn=None`` follows ``use_kernels``, as the JAX
        encoder's follows ``use_pallas`` (a WavLM config's stays plain); an
        explicit False keeps the conv and FFN kernels while attention stays
        plain.  ``use_fused_qkv`` computes every layer's q, k and v in one
        product (:class:`EncoderLayer`).  On a CUDA device a config the chosen
        kernels do not take is refused here (:func:`kernel_limits`); flash
        attention for a config with a position bias is refused on any
        device, since no route may drop the bias."""
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        rel_bias = position_bias_limit(cfg)
        flash = ((use_kernels and not rel_bias) if use_flash_attn is None
                 else use_flash_attn)
        if flash and rel_bias:
            raise ValueError(f"Wav2Vec2Encoder: {rel_bias}")
        refuse_kernel_limit("Wav2Vec2Encoder", device,
                            kernel_limits(cfg, use_kernels, flash, mega))
        self.feature_encoder = ConvFeatureEncoder(cfg, device=device,
                                                  use_kernels=use_kernels,
                                                  mega=mega)
        self.proj_norm = LayerNorm(cfg.conv_dims[-1], device=device)
        self.proj = nn.Linear(cfg.conv_dims[-1], cfg.hidden_dim, device=device)
        self.pos_conv = PosConvEmbed(cfg, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device=device, use_kernels=use_kernels,
                         use_flash_attn=flash, use_fused_qkv=use_fused_qkv,
                         rel_embed=i == 0)
            for i in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_dim, device=device)

    def forward(self, wave: torch.Tensor,
                frame_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encode_frames(self.feature_encoder(wave), frame_pad_mask)

    def encode_frames(self, feats: torch.Tensor,
                      frame_pad_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The encoder after its conv stack: frame features (B, T,
        conv_dims[-1]) → the projection, the positional conv and the
        transformer layers → (B, T, hidden_dim) f32."""
        dt = torch_dtype(self.cfg)
        x = dense(self.proj_norm(feats), self.proj, dt).float()
        # Padded frames are zeroed before the (full-context) positional conv.
        x = self.pos_conv(x, frame_pad_mask, self.use_kernels)
        rel = self.position_bias(x.shape[1], x.device)
        for layer in self.layers:
            x = layer(x, frame_pad_mask, rel)
        return self.final_norm(x)

    def position_bias(self, t: int, device: torch.device) -> Optional[torch.Tensor]:
        """The table (H, t, t) every layer gates, built once a forward
        inside the span ``mmer.wavlm.rel_bias``; None without a position
        bias (Wav2Vec2)."""
        if not isinstance(self.cfg, WavLMConfig):
            return None
        with span("mmer.wavlm.rel_bias"):
            return self.layers[0].position_bias(t, device)


def init_wav2vec2(cfg: Wav2Vec2Config, *, device: torch.device | str,
                  use_kernels: bool = True,
                  use_flash_attn: Optional[bool] = None,
                  mega: bool = True,
                  use_fused_qkv: bool = False) -> Wav2Vec2Encoder:
    """The JAX package's seeded Wav2Vec2, ``AudioEmbedder(cfg)``'s params for
    ``cfg.param_seed``, drawn on ``device`` without JAX
    (:mod:`~mmer_tpu_torch.models.jax_init`).  A WavLM config takes the
    same draws for the params it shares (its conv biases dropped) and
    draws its position bias's from ``cfg.param_seed``
    (:func:`draw_position_bias`)."""
    model = Wav2Vec2Encoder(cfg, device=device, use_kernels=use_kernels,
                            use_flash_attn=use_flash_attn, mega=mega,
                            use_fused_qkv=use_fused_qkv)
    sd = wav2vec2_from_flax(jax_init.wav2vec2_tree(cfg, device=device))
    if isinstance(cfg, WavLMConfig):
        keep = model.state_dict()
        sd = {k: v for k, v in sd.items() if k in keep}
        sd.update(draw_position_bias(cfg, device))
    model.load_state_dict(sd)
    return model.eval()


def draw_position_bias(cfg: WavLMConfig, device: torch.device | str) -> dict:
    """A WavLM encoder's position-bias params for ``cfg.param_seed``, drawn
    on the host as their ``nn`` modules initialise them: ``E`` ~ N(0, 1);
    each gate's weight and bias uniform in ±1/sqrt(head_dim); κ = 1."""
    gen = torch.Generator().manual_seed(cfg.param_seed)
    h = cfg.num_heads
    bound = (cfg.hidden_dim // h) ** -0.5

    def uniform(*shape):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    out = {"layers.0.rel_attn_embed.weight": torch.randn(cfg.num_buckets, h,
                                                         generator=gen)}
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        out[pre + "gru_rel_pos_linear.weight"] = uniform(8, cfg.hidden_dim // h)
        out[pre + "gru_rel_pos_linear.bias"] = uniform(8)
        out[pre + "gru_rel_pos_const"] = torch.ones(h)
    return {k: v.to(device) for k, v in out.items()}


def pool_embeddings(hidden: torch.Tensor, frame_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Per-frame hidden states (B, T, d) and their frame pad mask → the
    L2-normalised mean of each row's unpadded frames, (B, d)."""
    keep = (~frame_mask).unsqueeze(-1).to(hidden.dtype)
    emb = (hidden * keep).sum(1) / keep.sum(1).clamp_min(1.0)
    return emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)


class AudioEmbedder:
    """Batched waveforms → L2-normalised (hidden_dim,) embeddings.

    Each waveform is normalised to zero mean / unit variance (var + 1e-7),
    clips longer than ``cfg.chunk_duration_s`` are split, pieces are padded
    to 1 s length buckets and a :func:`batch_bucket` batch (extra rows repeat
    the last piece), and the model, the length-masked mean pool and the L2
    norm run on ``device``; a split clip's piece embeddings are averaged and
    normalised again on the host.

    ``params``: a state dict for :class:`Wav2Vec2Encoder`; else
    ``params_path`` (a flax ``.msgpack`` of the JAX encoder's params, as
    ``port_wav2vec2`` writes a converted HF checkpoint, or an ``.npz`` state
    dict) is loaded if it exists and written with the seeded weights if not;
    else the weights are the JAX package's seeded init for ``cfg.param_seed``
    (:func:`init_wav2vec2`).  A :class:`WavLMConfig` runs WavLM; its params
    file is an ``.npz`` state dict, since the flax layout has no place for
    the position bias.

    By default attention stays plain (``use_flash_attn=False``) and the conv
    encoder on its ``mega`` route, as in the JAX ``AudioEmbedder``; with
    ``use_kernels`` on the card the plain route's arithmetic is one kernel a
    layer (WavLM's gated layers keep its torch ops).  Which attention route
    is faster on the card is recorded in PERF.md, not decided here.
    ``use_flash_attn=True, mega=False`` builds the all-kernel encoder
    (varlen flash attention, per-layer conv route).  ``use_fused_qkv``
    (default off, as in JAX) computes q, k and v in one product a layer.

    ``mesh`` (``core/mesh.py``, every rank constructing the embedder alike):
    the padded batch is rounded up to a multiple of the data axis, each rank
    embeds its rows (model, pool and norm) on ``device``, and one all-gather
    over the data axis returns all rows to every rank (JAX
    ``models/wav2vec2.py:500-551``).  The JAX embedder's split positional
    conv (``_SplitGroupedConv``) works around XLA's partitioner and has no
    counterpart here.
    """

    def __init__(self, cfg: Optional[Wav2Vec2Config] = None, *,
                 device: torch.device | str,
                 params: Optional[dict] = None,
                 params_path: Optional[str] = None,
                 use_kernels: bool = True,
                 use_flash_attn: bool = False, mega: bool = True,
                 use_fused_qkv: bool = False,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg or Wav2Vec2Config()
        if (isinstance(self.cfg, WavLMConfig) and params is None and params_path
                and params_path.endswith(".msgpack")):
            raise ValueError("AudioEmbedder: a WavLM params file is an .npz state "
                             "dict; the flax .msgpack layout holds no position bias")
        self.device = torch.device(device)
        self.mesh = active_mesh(mesh, self.device)
        kw = dict(device=self.device, use_kernels=use_kernels,
                  use_flash_attn=use_flash_attn, mega=mega,
                  use_fused_qkv=use_fused_qkv)
        self.model = load_or_save_params(
            lambda: Wav2Vec2Encoder(self.cfg, **kw),
            lambda: init_wav2vec2(self.cfg, **kw), params, params_path,
            from_flax=wav2vec2_from_flax,
            to_flax=lambda sd: wav2vec2_to_flax(sd, self.cfg.num_heads))

    def _bucket_len(self, n: int) -> int:
        step = self.cfg.sample_rate
        return max(step, -(-n // step) * step)

    @torch.inference_mode()
    def _embed_padded(self, waves: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Pieces padded to one length (N, L) and their sample counts →
        their embeddings (N, hidden_dim): frame mask and :func:`batch_bucket`
        rows (the last piece repeated), the device's rows, the fetch.  Counts
        ``w2v2.frames_useful`` (the real pieces' frames among the rows this
        process runs) and ``w2v2.frames_computed`` (those rows times the
        padded frames)."""
        cfg = self.cfg
        with span("mmer.w2v2.pad"):
            t_out = feat_extract_output_length(cfg, waves.shape[1])
            frame_lens = np.asarray(
                [feat_extract_output_length(cfg, int(n)) for n in lengths])
            mask = np.arange(t_out)[None, :] >= frame_lens[:, None]
            n = waves.shape[0]
            n_pad = batch_bucket(n)
            rows = slice(None)
            if self.mesh is not None:
                n_pad = pad_to_multiple(n_pad, self.mesh.dp)
                rows = self.mesh.batch_rows(n_pad)
            if n_pad > n:
                waves = np.concatenate([waves, np.repeat(waves[-1:], n_pad - n, 0)])
                mask = np.concatenate([mask, np.repeat(mask[-1:], n_pad - n, 0)])
            run = np.arange(n_pad)[rows]
            count("w2v2.frames_useful", int(frame_lens[run[run < n]].sum()))
            count("w2v2.frames_computed", len(run) * t_out)
        with span("mmer.w2v2.upload"):
            waves_d = torch.from_numpy(waves[rows]).to(self.device)
            mask_d = torch.from_numpy(mask[rows]).to(self.device)
        with span("mmer.w2v2.forward"):
            emb = self.embed_rows(waves_d, mask_d)
            if self.mesh is not None:
                emb = self.mesh.all_gather_rows(emb)
        with span("mmer.w2v2.fetch"):
            return emb.float().cpu().numpy()[:n]

    @torch.inference_mode()
    def embed_rows(self, waves: torch.Tensor, frame_mask: torch.Tensor
                   ) -> torch.Tensor:
        """Padded waveforms and their frame pad mask, on the device → the
        L2-normalised length-masked mean of the encoder's output, per row
        (the JAX embedder's ``apply_pool``)."""
        return pool_embeddings(self.model(waves, frame_mask), frame_mask)

    def embed_batch(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        """list of 1-D float waveforms (16 kHz) → (B, hidden_dim) float32.
        Marked by the spans ``mmer.w2v2.normalise``, ``.pad`` (twice),
        ``.upload``, ``.forward``, ``.fetch`` and ``.merge``
        (``utils/profiling.py``), in that order."""
        cfg = self.cfg
        chunk = int(cfg.chunk_duration_s * cfg.sample_rate)
        pieces: List[np.ndarray] = []
        owners: List[int] = []
        with span("mmer.w2v2.normalise"):
            for bi, wave in enumerate(waveforms):
                wave = np.asarray(wave, np.float32)
                wave = (wave - wave.mean()) / np.sqrt(wave.var() + 1e-7)
                for start in range(0, max(len(wave), 1), chunk):
                    piece = wave[start:start + chunk]
                    pieces.append(piece if len(piece) else np.zeros(1, np.float32))
                    owners.append(bi)

        with span("mmer.w2v2.pad"):
            batch = np.zeros((len(pieces), self._bucket_len(max(map(len, pieces)))),
                             np.float32)
            lengths = np.zeros(len(pieces), np.int64)
            for i, p in enumerate(pieces):
                batch[i, :len(p)] = p
                lengths[i] = len(p)
        piece_embs = self._embed_padded(batch, lengths)

        with span("mmer.w2v2.merge"):
            owners_arr = np.asarray(owners)
            out = np.zeros((len(waveforms), cfg.hidden_dim), np.float32)
            for bi in range(len(waveforms)):
                emb = piece_embs[owners_arr == bi].mean(axis=0)
                out[bi] = emb / np.maximum(np.linalg.norm(emb), 1e-12)
        return out

