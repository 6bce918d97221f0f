"""ViViT chunk embedder, the port of ``mmer_tpu/models/vivit.py``.

(B, 32, 224, 224, 3) frames in [0, 1] → (B, 768) CLS features: tubelet
patchify as a reshape plus one Linear (token order (t', h', w'), each
tubelet flattened as (t, ph, pw, C)), a learned positional embedding sliced
to the token count, 12 pre-norm blocks, no final LayerNorm.

Params stay float32; activations run in the compute dtype (bf16: the
residual stream is bf16 from the tubelet GEMM on), LayerNorms in float32.
Attention goes through :func:`~mmer_tpu_torch.ops.flash_attention.flash_attention`
and the FFN sublayer through :func:`~mmer_tpu_torch.ops.fused_blocks.fused_ffn`
(the kernel route the JAX package takes for extraction); ``use_kernels=False``
runs their plain PyTorch versions instead.
"""

from __future__ import annotations

import torch
from torch import nn

from mmer_tpu_torch.config import ViViTConfig, torch_dtype
from mmer_tpu_torch.models.layers import (LayerNorm, dense, init_like_flax,
                                         param_generator)
from mmer_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from mmer_tpu_torch.ops.fused_blocks import ffn_reference, fused_ffn


def max_tokens(cfg: ViViTConfig) -> int:
    return ((cfg.num_frames // cfg.tubelet_size)
            * (cfg.image_size[0] // cfg.patch_size[0])
            * (cfg.image_size[1] // cfg.patch_size[1])
            + (1 if cfg.pool == "cls" else 0))


class TubeletEmbed(nn.Module):
    """Non-overlapping tubelet patchify: (B, F, H, W, C) → (B, N, dim)."""

    def __init__(self, cfg: ViViTConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        ph, pw = cfg.patch_size
        self.proj = nn.Linear(cfg.tubelet_size * ph * pw * cfg.in_channels,
                              cfg.dim, device=device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = torch_dtype(cfg)
        b, f, hh, ww, c = video.shape
        t = cfg.tubelet_size
        ph, pw = cfg.patch_size
        ft, hp, wp = f // t, hh // ph, ww // pw
        # Rounding to the compute dtype first is the same elementwise cast the
        # JAX module applies after its transpose, at half the bytes moved.
        x = video.to(dt).reshape(b, ft, t, hp, ph, wp, pw, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, ft * hp * wp,
                                                      t * ph * pw * c)
        return dense(x, self.proj, dt)


class PreNormBlock(nn.Module):
    """x = x + Attn(LN(x)); x = x + FFN(LN(x)) (bias-free qkv and out)."""

    def __init__(self, cfg: ViViTConfig, *, device: torch.device | str,
                 use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        inner = cfg.heads * cfg.dim_head
        self.norm1 = LayerNorm(cfg.dim, device=device)
        self.to_qkv = nn.Linear(cfg.dim, 3 * inner, bias=False, device=device)
        self.to_out = nn.Linear(inner, cfg.dim, bias=False, device=device)
        self.norm2 = LayerNorm(cfg.dim, device=device)
        self.ffn_in = nn.Linear(cfg.dim, cfg.mlp_dim, device=device)
        self.ffn_out = nn.Linear(cfg.mlp_dim, cfg.dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = torch_dtype(cfg)
        b, s, _ = x.shape
        h, hd = cfg.heads, cfg.dim_head

        qkv = dense(self.norm1(x), self.to_qkv, dt)
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2).contiguous()
                   for t in qkv.chunk(3, dim=-1))
        attend = flash_attention if self.use_kernels else reference_attention
        attn = attend(q, k, v).transpose(1, 2).reshape(b, s, h * hd)
        x = x + dense(attn, self.to_out, dt).to(x.dtype)

        ffn = fused_ffn if self.use_kernels else ffn_reference
        return ffn(x, self.norm2.weight, self.norm2.bias,
                   self.ffn_in.weight.to(dt), self.ffn_in.bias,
                   self.ffn_out.weight.to(dt), self.ffn_out.bias)


class ViViTFeatureExtractor(nn.Module):
    """Batched chunk embedder: (B, F, H, W, C) → (B, dim) float32."""

    def __init__(self, cfg: ViViTConfig, *, device: torch.device | str,
                 use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.embed = TubeletEmbed(cfg, device=device)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, d, device=device))
                          if cfg.pool == "cls" else None)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, max_tokens(cfg), d, device=device))
        self.blocks = nn.ModuleList(
            PreNormBlock(cfg, device=device, use_kernels=use_kernels)
            for _ in range(cfg.depth))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = self.embed(video)
        b, n, d = x.shape
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
            n += 1
        if n > self.pos_embed.shape[1]:
            raise ValueError(f"chunk produces {n} tokens > configured maximum "
                             f"{self.pos_embed.shape[1]}")
        x = x + self.pos_embed[:, :n].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        feats = x[:, 0] if self.cls_token is not None else x.mean(dim=1)
        return feats.float()


def init_vivit(cfg: ViViTConfig, *, device: torch.device | str,
               generator: torch.Generator | None = None,
               use_kernels: bool = True) -> ViViTFeatureExtractor:
    """A seeded ViViT drawn from flax's initializer families (Dense
    ``lecun_normal`` with zero bias, LayerNorm (1, 0), ``cls_token`` and
    ``pos_embed`` N(0, 1)); the generator defaults to ``cfg.param_seed``
    on ``device``.  Torch's RNG cannot reproduce the JAX draws: the values
    differ from the JAX package's, the distributions do not."""
    model = ViViTFeatureExtractor(cfg, device=device, use_kernels=use_kernels)
    g = generator or param_generator(cfg.param_seed, device)
    init_like_flax(model, g)
    with torch.no_grad():
        if model.cls_token is not None:
            model.cls_token.normal_(0.0, 1.0, generator=g)
        model.pos_embed.normal_(0.0, 1.0, generator=g)
    return model.eval()
