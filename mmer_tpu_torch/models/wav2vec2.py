"""Wav2Vec2-large (robust variant) audio embedder, the port of
``mmer_tpu/models/wav2vec2.py``.

Waveform (B, L) at 16 kHz → per-frame hidden states (B, T, 1024) →
length-masked mean pool → L2 norm → (1024,):

- feature encoder: seven conv → LayerNorm → GELU layers through
  :func:`~mmer_tpu_torch.ops.conv_pyramid.fused_conv_encoder` (one CUDA
  kernel launch per layer on the card, on either of its two routes);
- feature projection LayerNorm(512) → Linear(1024), float32 stream;
- grouped positional conv (kernel 128, 16 groups, weight norm folded), the
  trailing frame trimmed for the even kernel, GELU, residual;
- 24 stable-layer-norm layers: masked attention with a finite −1e9 key
  bias (a fully masked row comes out uniform, not NaN), plain or, with
  ``use_flash_attn``, through
  :func:`~mmer_tpu_torch.ops.flash_attention.flash_attention` with one key
  length per clip; q, k and v from three projections or, with
  ``use_fused_qkv``, one product over their weights concatenated on every
  call; the FFN sublayer through
  :func:`~mmer_tpu_torch.ops.fused_blocks.fused_ffn`;
- a final LayerNorm.

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

from mmer_tpu_torch.config import Wav2Vec2Config, compute_dtype_limit, torch_dtype
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


def feat_extract_output_length(cfg: Wav2Vec2Config, input_length: int) -> int:
    """Conv-stack output length for a waveform length (VALID convs)."""
    length = input_length
    for kernel, stride in zip(cfg.conv_kernels, cfg.conv_strides):
        length = (length - kernel) // stride + 1
    return max(length, 0)


def kernel_limits(cfg: Wav2Vec2Config, use_kernels: bool = True,
                  use_flash_attn: bool = False, mega: bool = True) -> str | None:
    """The first limit of the CUDA kernels that a Wav2Vec2 config breaks on
    the routes named (with ``use_kernels`` the conv encoder on route ``mega``
    and the FFN, with ``use_flash_attn`` attention), as a sentence naming it;
    None if it breaks none.  The plain path takes any config."""
    limits = []
    if use_kernels:
        limits += [conv_pyramid.kernel_limits(cfg, mega),
                   ffn_limits(cfg.hidden_dim, cfg.ffn_dim)]
    if use_flash_attn:
        limits += [compute_dtype_limit(cfg),
                   attention_limits(cfg.hidden_dim // cfg.num_heads)]
    return next((limit for limit in limits if limit), None)


class ConvFeatureEncoder(nn.Module):
    """Raw waveform (B, L) → frame features (B, T, conv_dims[-1]).
    ``mega`` picks the route of ``fused_conv_encoder`` (whole-pyramid port or
    the per-layer merged-view kernels).  On a CUDA device with
    ``use_kernels`` a config the kernels do not take is refused here."""

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
        for dim, k, s in zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides):
            convs.append(nn.Conv1d(c_in, dim, k, stride=s, device=device))
            norms.append(LayerNorm(dim, device=device))
            c_in = dim
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def conv_params(self) -> tuple:
        """(conv weights, conv biases, LN weights, LN biases), the argument
        lists of ``fused_conv_encoder`` and ``conv_encoder_reference``."""
        return ([c.weight for c in self.convs], [c.bias for c in self.convs],
                [n.weight for n in self.norms], [n.bias for n in self.norms])

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        args = self.conv_params()
        if not self.use_kernels:
            return conv_encoder_reference(wave, *args, self.cfg)
        return fused_conv_encoder(wave, *args, self.cfg, mega=self.mega)


class PosConvEmbed(nn.Module):
    """Grouped positional convolution (weight norm folded into the kernel)."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_dim, cfg.hidden_dim, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups,
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        xt, w, b = x.to(dt).transpose(1, 2), self.conv.weight.to(dt), \
            self.conv.bias.to(dt)
        if xt.device.type == "cpu" and dt == torch.bfloat16:
            # PyTorch's CPU bf16 grouped conv1d returns wrong values (rel-L2
            # ~1 against the f32 conv of the same operands, torch 2.13).  The
            # same rounding points: bf16 operands, f32 sums, bf16 output.
            xt, w = xt.float(), w.float()
        # The bias is added to the rounded conv output, as flax's Conv does.
        y = F.conv1d(xt, w, padding=self.conv.padding,
                     groups=self.conv.groups).to(dt) + b[:, None]
        if self.cfg.num_conv_pos_embeddings % 2 == 0:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class EncoderLayer(nn.Module):
    """Stable-layer-norm transformer layer (pre-norm, biased projections)."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str,
                 use_kernels: bool = True, use_flash_attn: bool = False,
                 use_fused_qkv: bool = False):
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
        w = torch.cat([lin.weight.t() for lin in lins], dim=1).to(dt)
        bias = torch.cat([lin.bias for lin in lins]).to(dt)
        qkv = torch.matmul(yd.to(dt), w) + bias
        return qkv.split(yd.shape[-1], dim=-1)

    def _attention(self, yd: torch.Tensor,
                   pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Attention over the projected heads (:meth:`project_qkv`).  Plain,
        as the JAX ``_xla_attention``: f32 scores, −1e9 on padded keys, f32
        softmax, probabilities rounded to the compute dtype, f32 output.  With
        ``use_flash_attn``: q, k, v go to ``flash_attention`` in the compute
        dtype with one key length per clip (frame pads are a suffix, so a
        count is a complete mask) and the output comes back in that dtype."""
        cfg = self.cfg
        dt = torch_dtype(cfg)
        b, t, d = yd.shape
        h = cfg.num_heads
        hd = d // h
        q, k, v = (y.reshape(b, t, h, hd).transpose(1, 2)
                   for y in self.project_qkv(yd))
        if self.use_flash_attn:
            key_lens = None if pad_mask is None else (~pad_mask).sum(1)
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_lens=key_lens)
            return out.transpose(1, 2).reshape(b, t, d)
        q, k, v = q.float(), k.float(), v.float()
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if pad_mask is not None:
            scores = scores + pad_mask[:, None, None, :].float() * -1e9
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs.to(dt).float(), v)          # (B, H, T, hd)
        return out.transpose(1, 2).reshape(b, t, d)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        attn = self._attention(self.norm_attn(x).to(dt), pad_mask)
        attn = dense(attn, self.out, dt)
        x = x + attn.to(x.dtype)
        ffn = fused_ffn if self.use_kernels else ffn_reference
        return ffn(x, self.norm_ffn.weight, self.norm_ffn.bias,
                   self.ffn_in.weight.to(dt), self.ffn_in.bias.to(dt),
                   self.ffn_out.weight.to(dt), self.ffn_out.bias.to(dt))


class Wav2Vec2Encoder(nn.Module):
    """Waveform (B, L) → per-frame hidden states (B, T, hidden_dim) f32."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str,
                 use_kernels: bool = True,
                 use_flash_attn: Optional[bool] = None, mega: bool = True,
                 use_fused_qkv: bool = False):
        """``use_flash_attn=None`` follows ``use_kernels``, as the JAX
        encoder's follows ``use_pallas``; an explicit False keeps the conv and
        FFN kernels while attention stays plain.  ``use_fused_qkv`` computes
        every layer's q, k and v in one product (:class:`EncoderLayer`).  On a
        CUDA device a config the chosen kernels do not take is refused here
        (:func:`kernel_limits`)."""
        super().__init__()
        self.cfg = cfg
        flash = use_kernels if use_flash_attn is None else use_flash_attn
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
                         use_flash_attn=flash, use_fused_qkv=use_fused_qkv)
            for _ in range(cfg.num_layers))
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
        # Zero padded frames before the (full-context) positional conv.
        if frame_pad_mask is not None:
            x = x.masked_fill(frame_pad_mask[:, :, None], 0.0)
        x = x + self.pos_conv(x).float()
        for layer in self.layers:
            x = layer(x, frame_pad_mask)
        return self.final_norm(x)


def init_wav2vec2(cfg: Wav2Vec2Config, *, device: torch.device | str,
                  use_kernels: bool = True,
                  use_flash_attn: Optional[bool] = None,
                  mega: bool = True,
                  use_fused_qkv: bool = False) -> Wav2Vec2Encoder:
    """The JAX package's seeded Wav2Vec2, ``AudioEmbedder(cfg)``'s params for
    ``cfg.param_seed``, drawn on ``device`` without JAX
    (:mod:`~mmer_tpu_torch.models.jax_init`)."""
    model = Wav2Vec2Encoder(cfg, device=device, use_kernels=use_kernels,
                            use_flash_attn=use_flash_attn, mega=mega,
                            use_fused_qkv=use_fused_qkv)
    model.load_state_dict(wav2vec2_from_flax(
        jax_init.wav2vec2_tree(cfg, device=device)))
    return model.eval()


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
    (:func:`init_wav2vec2`).

    By default attention stays plain (``use_flash_attn=False``) and the conv
    encoder on its ``mega`` route, as in the JAX ``AudioEmbedder``; which
    attention route is faster on the card is recorded in PERF.md, not decided
    here.  ``use_flash_attn=True, mega=False`` builds the all-kernel encoder
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
        cfg = self.cfg
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
        emb = self.embed_rows(torch.from_numpy(waves[rows]).to(self.device),
                              torch.from_numpy(mask[rows]).to(self.device))
        if self.mesh is not None:
            emb = self.mesh.all_gather_rows(emb)
        return emb.float().cpu().numpy()[:n]

    @torch.inference_mode()
    def embed_rows(self, waves: torch.Tensor, frame_mask: torch.Tensor
                   ) -> torch.Tensor:
        """Padded waveforms and their frame pad mask, on the device → the
        L2-normalised length-masked mean of the encoder's output, per row
        (the JAX embedder's ``apply_pool``)."""
        return pool_embeddings(self.model(waves, frame_mask), frame_mask)

    def embed_batch(self, waveforms: Sequence[np.ndarray]) -> np.ndarray:
        """list of 1-D float waveforms (16 kHz) → (B, hidden_dim) float32."""
        cfg = self.cfg
        chunk = int(cfg.chunk_duration_s * cfg.sample_rate)
        pieces: List[np.ndarray] = []
        owners: List[int] = []
        for bi, wave in enumerate(waveforms):
            wave = np.asarray(wave, np.float32)
            wave = (wave - wave.mean()) / np.sqrt(wave.var() + 1e-7)
            for start in range(0, max(len(wave), 1), chunk):
                piece = wave[start:start + chunk]
                pieces.append(piece if len(piece) else np.zeros(1, np.float32))
                owners.append(bi)

        batch = np.zeros((len(pieces), self._bucket_len(max(map(len, pieces)))),
                         np.float32)
        lengths = np.zeros(len(pieces), np.int64)
        for i, p in enumerate(pieces):
            batch[i, :len(p)] = p
            lengths[i] = len(p)
        piece_embs = self._embed_padded(batch, lengths)

        owners_arr = np.asarray(owners)
        out = np.zeros((len(waveforms), cfg.hidden_dim), np.float32)
        for bi in range(len(waveforms)):
            emb = piece_embs[owners_arr == bi].mean(axis=0)
            out[bi] = emb / np.maximum(np.linalg.norm(emb), 1e-12)
        return out

