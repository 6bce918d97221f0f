"""Wav2Vec2-large (robust variant) audio embedder, the port of
``mmer_tpu/models/wav2vec2.py``.

Waveform (B, L) at 16 kHz → per-frame hidden states (B, T, 1024) →
length-masked mean pool → L2 norm → (1024,):

- feature encoder: seven conv → LayerNorm → GELU layers through
  :func:`~mmer_tpu_torch.ops.conv_pyramid.fused_conv_encoder` (one CUDA
  kernel launch per layer on the card);
- feature projection LayerNorm(512) → Linear(1024), float32 stream;
- grouped positional conv (kernel 128, 16 groups, weight norm folded), the
  trailing frame trimmed for the even kernel, GELU, residual;
- 24 stable-layer-norm layers: plain masked attention with a finite −1e9
  key bias (a fully masked row comes out uniform, not NaN), the FFN
  sublayer through :func:`~mmer_tpu_torch.ops.fused_blocks.fused_ffn`;
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

from mmer_tpu_torch.config import Wav2Vec2Config, torch_dtype
from mmer_tpu_torch.core.buckets import batch_bucket
from mmer_tpu_torch.models.layers import (LayerNorm, dense, init_like_flax,
                                         load_or_save_params, param_generator)
from mmer_tpu_torch.ops.conv_pyramid import (conv_encoder_reference,
                                             fused_conv_encoder, supports_config)
from mmer_tpu_torch.ops.fused_blocks import ffn_reference, fused_ffn


def feat_extract_output_length(cfg: Wav2Vec2Config, input_length: int) -> int:
    """Conv-stack output length for a waveform length (VALID convs)."""
    length = input_length
    for kernel, stride in zip(cfg.conv_kernels, cfg.conv_strides):
        length = (length - kernel) // stride + 1
    return max(length, 0)


class ConvFeatureEncoder(nn.Module):
    """Raw waveform (B, L) → frame features (B, T, conv_dims[-1])."""

    def __init__(self, cfg: Wav2Vec2Config, *, device: torch.device | str,
                 use_kernels: bool = True):
        super().__init__()
        if not supports_config(cfg):
            raise ValueError("ConvFeatureEncoder: only the layer-norm, stride-2 "
                             "k2/k3 conv stacks are ported")
        self.cfg = cfg
        self.use_kernels = use_kernels
        c_in = 1
        convs, norms = [], []
        for dim, k, s in zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides):
            convs.append(nn.Conv1d(c_in, dim, k, stride=s, device=device))
            norms.append(LayerNorm(dim, device=device))
            c_in = dim
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        run = fused_conv_encoder if self.use_kernels else conv_encoder_reference
        return run(wave, [c.weight for c in self.convs],
                   [c.bias for c in self.convs],
                   [n.weight for n in self.norms],
                   [n.bias for n in self.norms], self.cfg)


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
                 use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        d = cfg.hidden_dim
        self.norm_attn = LayerNorm(d, device=device)
        self.q = nn.Linear(d, d, device=device)
        self.k = nn.Linear(d, d, device=device)
        self.v = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)
        self.norm_ffn = LayerNorm(d, device=device)
        self.ffn_in = nn.Linear(d, cfg.ffn_dim, device=device)
        self.ffn_out = nn.Linear(cfg.ffn_dim, d, device=device)

    def _attention(self, yd: torch.Tensor,
                   pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Plain attention, as the JAX ``_xla_attention`` (the Pallas varlen
        kernel is off in JAX serving too): f32 scores, −1e9 on padded keys,
        f32 softmax, bf16 probabilities, f32 output."""
        cfg = self.cfg
        dt = torch_dtype(cfg)
        b, t, d = yd.shape
        h = cfg.num_heads
        hd = d // h

        def proj(lin):
            return dense(yd, lin, dt).reshape(b, t, h, hd).transpose(1, 2).float()

        q, k, v = proj(self.q), proj(self.k), proj(self.v)
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
                 use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = ConvFeatureEncoder(cfg, device=device,
                                                  use_kernels=use_kernels)
        self.proj_norm = LayerNorm(cfg.conv_dims[-1], device=device)
        self.proj = nn.Linear(cfg.conv_dims[-1], cfg.hidden_dim, device=device)
        self.pos_conv = PosConvEmbed(cfg, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device=device, use_kernels=use_kernels)
            for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_dim, device=device)

    def forward(self, wave: torch.Tensor,
                frame_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        feats = self.feature_encoder(wave)
        x = dense(self.proj_norm(feats), self.proj, dt).float()
        # Zero padded frames before the (full-context) positional conv.
        if frame_pad_mask is not None:
            x = x.masked_fill(frame_pad_mask[:, :, None], 0.0)
        x = x + self.pos_conv(x).float()
        for layer in self.layers:
            x = layer(x, frame_pad_mask)
        return self.final_norm(x)


def init_wav2vec2(cfg: Wav2Vec2Config, *, device: torch.device | str,
                  generator: torch.Generator | None = None,
                  use_kernels: bool = True) -> Wav2Vec2Encoder:
    """A seeded Wav2Vec2 drawn from flax's initializer families (Dense and
    Conv ``lecun_normal`` with zero bias, LayerNorm (1, 0)); the generator
    defaults to ``cfg.param_seed`` on ``device``."""
    model = Wav2Vec2Encoder(cfg, device=device, use_kernels=use_kernels)
    init_like_flax(model, generator or param_generator(cfg.param_seed, device))
    return model.eval()


class AudioEmbedder:
    """Batched waveforms → L2-normalised (hidden_dim,) embeddings.

    Each waveform is normalised to zero mean / unit variance (var + 1e-7),
    clips longer than ``cfg.chunk_duration_s`` are split, pieces are padded
    to 1 s length buckets and a :func:`batch_bucket` batch (extra rows repeat
    the last piece), and the model, the length-masked mean pool and the L2
    norm run on ``device``; a split clip's piece embeddings are averaged and
    normalised again on the host.

    ``params``: a state dict for :class:`Wav2Vec2Encoder`; else
    ``params_path`` (``.npz``) is loaded if it exists and written with the
    seeded weights if not; else the weights are seeded from
    ``cfg.param_seed``.
    """

    def __init__(self, cfg: Optional[Wav2Vec2Config] = None, *,
                 device: torch.device | str,
                 params: Optional[dict] = None,
                 params_path: Optional[str] = None,
                 use_kernels: bool = True):
        self.cfg = cfg or Wav2Vec2Config()
        self.device = torch.device(device)
        self.model = init_wav2vec2(self.cfg, device=self.device,
                                   use_kernels=use_kernels)
        load_or_save_params(self.model, params, params_path)

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
        if n_pad > n:
            waves = np.concatenate([waves, np.repeat(waves[-1:], n_pad - n, 0)])
            mask = np.concatenate([mask, np.repeat(mask[-1:], n_pad - n, 0)])
        w = torch.from_numpy(waves).to(self.device)
        m = torch.from_numpy(mask).to(self.device)
        hidden = self.model(w, m)
        keep = (~m).unsqueeze(-1).to(hidden.dtype)
        emb = (hidden * keep).sum(1) / keep.sum(1).clamp_min(1.0)
        emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return emb.float().cpu().numpy()[:n]

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

