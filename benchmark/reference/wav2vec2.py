"""Wav2Vec2 (layer-norm conv encoder, stable layer norm) audio embedder in
plain float32: the reference of the ``wav2vec2`` cells, with the host
semantics of ``AudioEmbedder.embed_batch``.

A clip is normalised to zero mean and unit variance (variance + 1e-7),
split into pieces of ``chunk_duration_s`` (the last one shorter), and each
piece is embedded alone, at its own length: seven conv → LayerNorm (over
channels) → GELU layers; LayerNorm and a Linear to ``hidden_dim``; a grouped
positional convolution (``num_conv_pos_embeddings`` taps, zero padding of
half of them, the trailing frame dropped for an even kernel), GELU, added
to the stream; ``num_layers`` pre-norm layers (biased q, k, v and output
projections, softmax attention over the piece's frames, exact-GELU FFN); a
final LayerNorm; the mean over the piece's frames; the L2 norm.  A piece too
short for one frame embeds as zeros.  A clip's embedding is the mean of its
pieces', L2-normalised again.

The port pads pieces to 1 s length buckets and to a power-of-two batch,
masks the padded frames out of attention and the pool, and zeroes them
before the positional convolution; computing each piece alone needs none of
that, so any error in it shows as a difference.  LayerNorm eps is 1e-6 as
in the port (flax's); the Hugging Face model uses 1e-5.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import full_float32, gelu, layer_norm


def param_shapes(m: dict) -> dict:
    """``name: (shape, kind, fan_in)`` in the port's state-dict layout."""
    shapes, c_in = {}, 1
    for i, (dim, k) in enumerate(zip(m["conv_dims"], m["conv_kernels"])):
        shapes[f"feature_encoder.convs.{i}.weight"] = ((dim, c_in, k), "dense", c_in * k)
        shapes[f"feature_encoder.convs.{i}.bias"] = ((dim,), "bias", 0)
        c_in = dim
    for i, dim in enumerate(m["conv_dims"]):
        shapes[f"feature_encoder.norms.{i}.weight"] = ((dim,), "ln_weight", 0)
        shapes[f"feature_encoder.norms.{i}.bias"] = ((dim,), "ln_bias", 0)
    d, f = m["hidden_dim"], m["ffn_dim"]
    k, g = m["num_conv_pos_embeddings"], m["num_conv_pos_embedding_groups"]
    shapes.update({
        "proj_norm.weight": ((c_in,), "ln_weight", 0),
        "proj_norm.bias": ((c_in,), "ln_bias", 0),
        "proj.weight": ((d, c_in), "dense", c_in),
        "proj.bias": ((d,), "bias", 0),
        "pos_conv.conv.weight": ((d, d // g, k), "dense", k * d // g),
        "pos_conv.conv.bias": ((d,), "bias", 0)})
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        for norm in ("norm_attn", "norm_ffn"):
            shapes[p + norm + ".weight"] = ((d,), "ln_weight", 0)
            shapes[p + norm + ".bias"] = ((d,), "ln_bias", 0)
        for lin in ("q", "k", "v", "out"):
            shapes[p + lin + ".weight"] = ((d, d), "dense", d)
            shapes[p + lin + ".bias"] = ((d,), "bias", 0)
        shapes[p + "ffn_in.weight"] = ((f, d), "dense", d)
        shapes[p + "ffn_in.bias"] = ((f,), "bias", 0)
        shapes[p + "ffn_out.weight"] = ((d, f), "dense", f)
        shapes[p + "ffn_out.bias"] = ((d,), "bias", 0)
    shapes["final_norm.weight"] = ((d,), "ln_weight", 0)
    shapes["final_norm.bias"] = ((d,), "ln_bias", 0)
    return shapes


def _lin(state: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ state[name + ".weight"].t() + state[name + ".bias"]


def piece_embedding(state: dict, m: dict, piece: torch.Tensor) -> torch.Tensor:
    """One normalised piece (L,) on the device → its (hidden_dim,) embedding,
    in the piece's dtype (that of ``state``'s tensors)."""
    x, p = piece.reshape(1, 1, -1), "feature_encoder."
    for i, s in enumerate(m["conv_strides"]):
        if x.shape[-1] < m["conv_kernels"][i]:
            return piece.new_zeros(m["hidden_dim"])
        x = F.conv1d(x, state[p + f"convs.{i}.weight"], state[p + f"convs.{i}.bias"],
                     stride=s)
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
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        y = layer_norm(x, state[p + "norm_attn.weight"], state[p + "norm_attn.bias"])
        q, kk, v = (_lin(state, p + n, y).reshape(1, t, h, hd).transpose(1, 2)
                    for n in ("q", "k", "v"))
        att = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
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
