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

from mmer_tpu_torch.config import ViViTConfig, compute_dtype_limit, torch_dtype
from mmer_tpu_torch.models import jax_init
from mmer_tpu_torch.models.convert import vivit_from_flax
from mmer_tpu_torch.models.layers import LayerNorm, dense, refuse_kernel_limit
from mmer_tpu_torch.ops.flash_attention import (attention_limits, flash_attention,
                                                reference_attention)
from mmer_tpu_torch.ops.fused_blocks import ffn_limits, ffn_reference, fused_ffn
from mmer_tpu_torch.utils.profiling import cast


def max_tokens(cfg: ViViTConfig) -> int:
    return ((cfg.num_frames // cfg.tubelet_size)
            * (cfg.image_size[0] // cfg.patch_size[0])
            * (cfg.image_size[1] // cfg.patch_size[1])
            + (1 if cfg.pool == "cls" else 0))


def kernel_limits(cfg: ViViTConfig) -> str | None:
    """The first limit of the CUDA kernels (attention, FFN) that a ViViT
    config breaks, as a sentence naming it; None if it breaks none.  The
    plain path takes any config."""
    return (compute_dtype_limit(cfg) or attention_limits(cfg.dim_head)
            or ffn_limits(cfg.dim, cfg.mlp_dim))


class TubeletEmbed(nn.Module):
    """Non-overlapping tubelet patchify: (B, F, H, W, C) → (B, N, dim)."""

    def __init__(self, cfg: ViViTConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        ph, pw = cfg.patch_size
        self.proj = nn.Linear(cfg.tubelet_size * ph * pw * cfg.in_channels,
                              cfg.dim, device=device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        dt = torch_dtype(self.cfg)
        # Rounding to the compute dtype first is the same elementwise cast the
        # JAX module applies after its transpose, at half the bytes moved.
        return dense(tubelets(video.to(dt), self.cfg), self.proj, dt)


def tubelets(video: torch.Tensor, cfg: ViViTConfig) -> torch.Tensor:
    """(B, F, H, W, C) → (B, N, t·ph·pw·C) in video's dtype: tokens in
    (t', h', w') order, each tubelet flattened as (t, ph, pw, C)."""
    b, f, hh, ww, c = video.shape
    t = cfg.tubelet_size
    ph, pw = cfg.patch_size
    ft, hp, wp = f // t, hh // ph, ww // pw
    x = video.reshape(b, ft, t, hp, ph, wp, pw, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, ft * hp * wp,
                                                     t * ph * pw * c)


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
                   cast(self.ffn_in.weight, dt), self.ffn_in.bias,
                   cast(self.ffn_out.weight, dt), self.ffn_out.bias)


class ViViTFeatureExtractor(nn.Module):
    """Batched chunk embedder: (B, F, H, W, C) → (B, dim) float32.  On a
    CUDA device with ``use_kernels`` a config the kernels do not take is
    refused here (:func:`kernel_limits`)."""

    def __init__(self, cfg: ViViTConfig, *, device: torch.device | str,
                 use_kernels: bool = True):
        super().__init__()
        if use_kernels:
            refuse_kernel_limit("ViViTFeatureExtractor", device, kernel_limits(cfg))
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
            x = torch.cat([cast(self.cls_token, x.dtype).expand(b, 1, d), x], dim=1)
            n += 1
        if n > self.pos_embed.shape[1]:
            raise ValueError(f"chunk produces {n} tokens > configured maximum "
                             f"{self.pos_embed.shape[1]}")
        x = x + cast(self.pos_embed[:, :n], x.dtype)
        for blk in self.blocks:
            x = blk(x)
        feats = x[:, 0] if self.cls_token is not None else x.mean(dim=1)
        return feats.float()


def init_vivit(cfg: ViViTConfig, *, device: torch.device | str,
               use_kernels: bool = True) -> ViViTFeatureExtractor:
    """The JAX package's seeded ViViT, ``init_vivit_params(cfg)`` for
    ``cfg.param_seed``, drawn on ``device`` without JAX
    (:mod:`~mmer_tpu_torch.models.jax_init`): the fixed random projection
    both packages extract and serve with."""
    model = ViViTFeatureExtractor(cfg, device=device, use_kernels=use_kernels)
    model.load_state_dict(vivit_from_flax(jax_init.vivit_tree(cfg, device=device)))
    return model.eval()
