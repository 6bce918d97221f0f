"""Operations and bytes of the work a cell asks for, counted from shapes.

A model's operations count 2 per multiply-add of its GEMMs, convolutions and
attention products, at the sizes the inputs need (not the padded sizes a
program may compute).  A kernel's bound counts each input byte read once and
each output byte written once (``chip_smoke.py:bound`` and
``mmer_tpu_torch/scripts/timing.py``, copied here).  ``m`` is a
configuration's ``model`` object (``configs/<name>.json``).
"""

from __future__ import annotations

from benchmark.peaks import bound_s

BF16, F32 = 2, 4


# -- ViViT -------------------------------------------------------------------

def vivit_patches(m: dict) -> int:
    """Tubelet tokens of one chunk."""
    return ((m["num_frames"] // m["tubelet_size"])
            * (m["image_size"][0] // m["patch_size"][0])
            * (m["image_size"][1] // m["patch_size"][1]))


def vivit_tokens(m: dict) -> int:
    """Tokens of one chunk: the tubelets and the CLS token."""
    return vivit_patches(m) + (1 if m["pool"] == "cls" else 0)


def vivit_patch_dim(m: dict) -> int:
    return (m["tubelet_size"] * m["patch_size"][0] * m["patch_size"][1]
            * m["in_channels"])


def vivit_attention_flops(m: dict) -> int:
    """One layer's two attention products, ``q kᵀ`` and ``p v``, one chunk."""
    s = vivit_tokens(m)
    return 4 * m["heads"] * s * s * m["dim_head"]


def vivit_chunk_flops(m: dict) -> int:
    """The tubelet projection and every layer's GEMMs and attention, one
    chunk (ViViT-B at 32 x 224², 4 x 16 x 16 tubelets: 364.7 GFLOP)."""
    s, d, inner = vivit_tokens(m), m["dim"], m["heads"] * m["dim_head"]
    per_layer = 2 * s * (4 * d * inner + 2 * d * m["mlp_dim"])
    return (2 * vivit_patches(m) * vivit_patch_dim(m) * d
            + m["depth"] * (per_layer + vivit_attention_flops(m)))


def attention_bound_s(rows: int, heads: int, seq: int, head_dim: int,
                      key_seq: int | None = None) -> float:
    """One attention launch over (rows, heads, seq, head_dim) bf16 q, k, v
    and output: ``4·seq·keys·head_dim`` operations a head."""
    keys = seq if key_seq is None else key_seq
    flops = 4.0 * rows * heads * seq * keys * head_dim
    return bound_s(flops, 4.0 * rows * heads * seq * head_dim * BF16)


# -- the pre-norm FFN sublayer (both models) ----------------------------------

def ffn_bound_s(n_tok: int, d: int, hidden: int, x_bytes: int,
                bias_bytes: int) -> float:
    """``x + GELU(LN(x) W1ᵀ + b1) W2ᵀ + b2`` over ``n_tok`` tokens: x read
    and the output written in x's dtype, LN params f32, W1 and W2 bf16, the
    biases in ``bias_bytes``."""
    flops = 4.0 * n_tok * hidden * d
    nbytes = (2 * n_tok * d * x_bytes + 2 * d * F32 + 2 * hidden * d * BF16
              + (hidden + d) * bias_bytes)
    return bound_s(flops, nbytes)


# -- Wav2Vec2 -----------------------------------------------------------------

def conv_lengths(m: dict, n_samples: int) -> list:
    """Output frames of each conv layer for a clip of ``n_samples`` (VALID
    convolutions)."""
    out, n = [], n_samples
    for k, s in zip(m["conv_kernels"], m["conv_strides"]):
        n = max((n - k) // s + 1, 0)
        out.append(n)
    return out


def w2v2_frames(m: dict, n_samples: int) -> int:
    return conv_lengths(m, n_samples)[-1]


def conv_encoder_flops(m: dict, n_samples: int) -> int:
    """The seven convolutions of one clip of ``n_samples``."""
    flops, c_in = 0, 1
    for dim, k, t in zip(m["conv_dims"], m["conv_kernels"],
                         conv_lengths(m, n_samples)):
        flops += 2 * t * k * c_in * dim
        c_in = dim
    return flops


def conv_encoder_bound_s(m: dict, rows: int, n_samples: int) -> float:
    """One pass of the conv encoder over ``rows`` clips of ``n_samples``:
    the f32 waves read, the bf16 frame features written, each layer's f32
    conv weight, bias and LayerNorm params read."""
    params, c_in = 0, 1
    for dim, k in zip(m["conv_dims"], m["conv_kernels"]):
        params += dim * c_in * k + 3 * dim
        c_in = dim
    nbytes = (rows * n_samples * F32
              + rows * w2v2_frames(m, n_samples) * c_in * BF16 + params * F32)
    return bound_s(float(rows) * conv_encoder_flops(m, n_samples), nbytes)


def w2v2_transformer_flops(m: dict, frames: int) -> int:
    """The feature projection, the grouped positional conv and the layers
    (q, k, v, out, the FFN, attention's two products over the clip's own
    frames) for one clip of ``frames``."""
    d, f, t = m["hidden_dim"], m["ffn_dim"], frames
    per_layer = 2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d
    pos_conv = (2 * t * d * (d // m["num_conv_pos_embedding_groups"])
                * m["num_conv_pos_embeddings"])
    return m["num_layers"] * per_layer + pos_conv + 2 * t * m["conv_dims"][-1] * d


def w2v2_piece_flops(m: dict, n_samples: int) -> int:
    """The whole encoder over one piece of ``n_samples``, at its own length."""
    return (conv_encoder_flops(m, n_samples)
            + w2v2_transformer_flops(m, w2v2_frames(m, n_samples)))
