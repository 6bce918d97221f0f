"""WavLM-Large audio embedder in plain float32: the reference of the
``wavlm`` cells, with the host semantics of ``AudioEmbedder.embed_batch``.

The Wav2Vec2 reference (``wav2vec2.py``: normalisation, 10 s pieces, each
piece embedded alone at its own length, the mean of a clip's pieces, the L2
norms) with WavLM's two differences (arXiv:2110.13900 §2; Hugging Face
``WavLMAttention``, ``WavLMEncoderStableLayerNorm``):

- the seven convolutions of the feature encoder have no bias;
- each layer's attention scores gain a gated relative position bias,
  ``q·kᵀ/√d + g[h, q] · rel[h, q, k]``.  ``rel[h, q, k] = E[bucket(k - q),
  h]`` is computed once a piece from layer 0's ``(num_buckets, H)``
  embedding ``E`` and used ungated by every layer.  Each layer's gate comes
  from the query frame's own normed stream: each head's slice through the
  shared ``(8, head_dim)`` linear map, its 8 outputs summed in two groups
  of four, ``a, c = σ(·)``, ``g = a · (c · κ_h − 1) + 2`` with the layer's
  per-head ``κ``.

A piece alone has no padded keys, so no key mask is applied here; the port
masks its padded keys with a finite −1e9 where Hugging Face uses −inf.
LayerNorm eps is 1e-6, the port's, where the published config has 1e-5.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import full_float32, gelu, layer_norm, wav2vec2
from benchmark.reference.wav2vec2 import _lin

GATE_OUT = 8


def param_shapes(m: dict) -> dict:
    """``name: (shape, kind, fan_in)`` in the port's state-dict layout: the
    Wav2Vec2 encoder's without the conv biases, with the position bias's.
    ``E`` is ``dense`` of fan-in 1 (a unit normal, ``nn.Embedding``'s init),
    so that the bias is the size of the scores; ``κ`` is ``ln_weight``."""
    shapes = {k: v for k, v in wav2vec2.param_shapes(m).items()
              if not (k.startswith("feature_encoder.convs.") and k.endswith(".bias"))}
    h = m["num_heads"]
    hd = m["hidden_dim"] // h
    shapes["layers.0.rel_attn_embed.weight"] = ((m["num_buckets"], h), "dense", 1)
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        shapes[p + "gru_rel_pos_linear.weight"] = ((GATE_OUT, hd), "dense", hd)
        shapes[p + "gru_rel_pos_linear.bias"] = ((GATE_OUT,), "bias", 0)
        shapes[p + "gru_rel_pos_const"] = ((h,), "ln_weight", 0)
    return shapes


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of each relative position ``rel = k - q``: ``num_buckets
    // 2`` a direction, offset by that for ``rel > 0``; exact below half of
    that, then log-spaced up to ``max_distance``, capped at the direction's
    last bucket (Hugging Face ``_relative_positions_bucket``, in float32)."""
    n = num_buckets // 2
    exact = n // 2
    a = rel.abs()
    large = exact + (torch.log(a.clamp_min(1).float() / exact)
                     / math.log(max_distance / exact) * (n - exact)).long()
    large = torch.minimum(large, torch.full_like(large, n - 1))
    return (rel > 0).long() * n + torch.where(a < exact, a, large)


def piece_embedding(state: dict, m: dict, piece: torch.Tensor) -> torch.Tensor:
    """One normalised piece (L,) on the device → its (hidden_dim,) embedding,
    in the piece's dtype (that of ``state``'s tensors)."""
    x, p = piece.reshape(1, 1, -1), "feature_encoder."
    for i, s in enumerate(m["conv_strides"]):
        if x.shape[-1] < m["conv_kernels"][i]:
            return piece.new_zeros(m["hidden_dim"])
        x = F.conv1d(x, state[p + f"convs.{i}.weight"], None, stride=s)
        x = gelu(layer_norm(x.transpose(1, 2), state[p + f"norms.{i}.weight"],
                            state[p + f"norms.{i}.bias"])).transpose(1, 2)
    x = x.transpose(1, 2)                                    # (1, T, C)
    if x.shape[1] == 0:
        return piece.new_zeros(m["hidden_dim"])
    x = _lin(state, "proj", layer_norm(x, state["proj_norm.weight"],
                                       state["proj_norm.bias"]))
    k = m["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), state["pos_conv.conv.weight"],
                   state["pos_conv.conv.bias"], padding=k // 2,
                   groups=m["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + gelu(pos).transpose(1, 2)
    t, d, h = x.shape[1], m["hidden_dim"], m["num_heads"]
    hd = d // h
    frames = torch.arange(t, device=x.device)
    buckets = bucket(frames[None, :] - frames[:, None], m["num_buckets"],
                     m["max_bucket_distance"])
    rel = state["layers.0.rel_attn_embed.weight"][buckets].permute(2, 0, 1)
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        y = layer_norm(x, state[p + "norm_attn.weight"], state[p + "norm_attn.bias"])
        q, kk, v = (_lin(state, p + n, y).reshape(1, t, h, hd).transpose(1, 2)
                    for n in ("q", "k", "v"))
        proj = _lin(state, p + "gru_rel_pos_linear",
                    y.reshape(1, t, h, hd).transpose(1, 2))          # (1, H, T, 8)
        a, c = torch.sigmoid(proj.reshape(1, h, t, 2, GATE_OUT // 2).sum(-1)).unbind(-1)
        gate = a * (c * state[p + "gru_rel_pos_const"].reshape(1, h, 1) - 1.0) + 2.0
        scores = q @ kk.transpose(-1, -2) / math.sqrt(hd) + gate[..., None] * rel
        att = torch.softmax(scores, dim=-1) @ v
        x = x + _lin(state, p + "out", att.transpose(1, 2).reshape(1, t, d))
        y = layer_norm(x, state[p + "norm_ffn.weight"], state[p + "norm_ffn.bias"])
        x = x + _lin(state, p + "ffn_out", gelu(_lin(state, p + "ffn_in", y)))
    x = layer_norm(x, state["final_norm.weight"], state["final_norm.bias"])
    emb = x[0].mean(0)
    return emb / emb.norm().clamp_min(1e-12)


def clip_embedding(state: dict, m: dict, wave: np.ndarray,
                   device: torch.device) -> torch.Tensor:
    """One clip (1-D float waveform at ``sample_rate``) → (hidden_dim,), in
    the dtype of ``state``'s tensors."""
    w = torch.as_tensor(np.asarray(wave, np.float64), device=device)
    w = ((w - w.mean()) / torch.sqrt(w.var(unbiased=False) + 1e-7))
    w = w.to(state["proj.weight"].dtype)
    size = int(m["chunk_duration_s"] * m["sample_rate"])
    pieces = [w[s:s + size] for s in range(0, len(w), size)]
    emb = torch.stack([piece_embedding(state, m, p) for p in pieces]).mean(0)
    return emb / emb.norm().clamp_min(1e-12)


@torch.no_grad()
def outputs(state: dict, m: dict, items, device: torch.device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference embedding of every clip of ``items`` (a list of 1-D
    waveforms on the host), computed in ``dtype`` (float32, or a lower
    precision for a control) → (N, hidden_dim) float32 on the host."""
    state = {k: v.to(dtype) for k, v in state.items()}
    with full_float32():
        return torch.stack([clip_embedding(state, m, w, device).float().cpu()
                            for w in items])
