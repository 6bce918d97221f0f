"""ViViT chunk embedder in plain float32: the reference of the ``vivit`` cells.

A chunk of F frames of H x W x C uint8 pixels is scaled by 1/255, cut into
non-overlapping t x ph x pw tubelets (tokens in (t', h', w') order, each
flattened as (t, ph, pw, C)), projected by one Linear, given a CLS token and
a learned positional embedding, and run through ``depth`` pre-norm blocks
(``x + Attn(LN(x))``, bias-free q/k/v and output projections; ``x +
FFN(LN(x))``, exact GELU).  The feature is the CLS token's row.  As the
port's module (the JAX package's), it has no final LayerNorm, which
lucidrains' ViViT and Arnab et al. put before the head.

``embed_chunks`` has no other host semantics to rebuild: the port pads a
device batch by repeating its last chunk and drops those rows; here every
chunk is computed alone, in blocks that do not need padding.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import full_float32, gelu, layer_norm


def param_shapes(m: dict) -> dict:
    """``name: (shape, kind, fan_in)`` in the port's state-dict layout."""
    d, inner, hid = m["dim"], m["heads"] * m["dim_head"], m["mlp_dim"]
    patch = (m["tubelet_size"] * m["patch_size"][0] * m["patch_size"][1]
             * m["in_channels"])
    tokens = ((m["num_frames"] // m["tubelet_size"])
              * (m["image_size"][0] // m["patch_size"][0])
              * (m["image_size"][1] // m["patch_size"][1]) + 1)
    shapes = {"cls_token": ((1, 1, d), "embed", 0),
              "pos_embed": ((1, tokens, d), "embed", 0),
              "embed.proj.weight": ((d, patch), "dense", patch),
              "embed.proj.bias": ((d,), "bias", 0)}
    for i in range(m["depth"]):
        p = f"blocks.{i}."
        shapes.update({
            p + "norm1.weight": ((d,), "ln_weight", 0),
            p + "norm1.bias": ((d,), "ln_bias", 0),
            p + "to_qkv.weight": ((3 * inner, d), "dense", d),
            p + "to_out.weight": ((d, inner), "dense", inner),
            p + "norm2.weight": ((d,), "ln_weight", 0),
            p + "norm2.bias": ((d,), "ln_bias", 0),
            p + "ffn_in.weight": ((hid, d), "dense", d),
            p + "ffn_in.bias": ((hid,), "bias", 0),
            p + "ffn_out.weight": ((d, hid), "dense", hid),
            p + "ffn_out.bias": ((d,), "bias", 0)})
    return shapes


def forward(state: dict, m: dict, video_u8: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, C) uint8 on the reference's device → (B, dim), computed
    in the dtype of ``state``'s tensors."""
    if m["pool"] != "cls":
        raise ValueError("the reference covers the CLS pool")
    x = (video_u8.float() / 255.0).to(state["embed.proj.weight"].dtype)
    b, f, hh, ww, c = x.shape
    t, (ph, pw) = m["tubelet_size"], m["patch_size"]
    x = x.reshape(b, f // t, t, hh // ph, ph, ww // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, t * ph * pw * c)
    x = x @ state["embed.proj.weight"].t() + state["embed.proj.bias"]
    d = x.shape[-1]
    x = torch.cat([state["cls_token"].expand(b, 1, d), x], dim=1)
    n = x.shape[1]
    x = x + state["pos_embed"][:, :n]
    h, hd = m["heads"], m["dim_head"]
    for i in range(m["depth"]):
        p = f"blocks.{i}."
        y = layer_norm(x, state[p + "norm1.weight"], state[p + "norm1.bias"])
        q, k, v = (y @ state[p + "to_qkv.weight"].t()).chunk(3, dim=-1)
        q, k, v = (z.reshape(b, n, h, hd).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
        x = x + att.transpose(1, 2).reshape(b, n, h * hd) @ state[p + "to_out.weight"].t()
        y = layer_norm(x, state[p + "norm2.weight"], state[p + "norm2.bias"])
        y = gelu(y @ state[p + "ffn_in.weight"].t() + state[p + "ffn_in.bias"])
        x = x + y @ state[p + "ffn_out.weight"].t() + state[p + "ffn_out.bias"]
    return x[:, 0]


@torch.no_grad()
def outputs(state: dict, m: dict, items, device: torch.device,
            block: int = 8, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference feature of every chunk of ``items`` ((N, F, H, W, C)
    uint8, on the host), computed ``block`` chunks at a time in ``dtype``
    (float32, or a lower precision for a control) → (N, dim) float32 on the
    host."""
    state = {k: v.to(dtype) for k, v in state.items()}
    out = []
    with full_float32():
        for s in range(0, len(items), block):
            chunk = torch.as_tensor(items[s:s + block]).to(device)
            out.append(forward(state, m, chunk).float().cpu())
    return torch.cat(out)
