"""``AudioEmbedder.embed_batch`` of ``mmer_tpu_torch`` over a Wav2Vec2
configuration."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.systems import Program
from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder


def port_config(config: dict) -> Wav2Vec2Config:
    return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in config["model"].items()})


def build(config: dict, traffic: dict, state: dict,
          device: torch.device) -> Program:
    emb = AudioEmbedder(port_config(config), device=device, params=state,
                        **config["route"])
    return Program(call=emb.embed_batch, target=emb)


def pieces(arg, m: dict) -> list:
    """Sample counts of the pieces ``embed_batch`` splits the call's clips
    into (``chunk_duration_s`` each, the last one shorter)."""
    size = int(m["chunk_duration_s"] * m["sample_rate"])
    return [min(size, len(w) - s) for w in arg for s in range(0, len(w), size)]


def useful(arg, config: dict) -> float:
    return sum(len(w) for w in arg) / config["model"]["sample_rate"]


def flops(arg, config: dict) -> float:
    m = config["model"]
    return float(sum(work.w2v2_piece_flops(m, n) for n in pieces(arg, m)))


def batch_rows(n: int) -> int:
    """Rows of the padded batch of ``n`` pieces: powers of two up to 128,
    then multiples of 128 (``mmer_tpu_torch/core/buckets.py:batch_bucket``)."""
    if n <= 1:
        return 1
    return -(-n // 128) * 128 if n >= 128 else 1 << (n - 1).bit_length()


def forwards(arg, config: dict, traffic: dict) -> list:
    """One forward a call: its pieces padded to the longest one's whole
    second and to :func:`batch_rows` rows."""
    m = config["model"]
    rate, lens = m["sample_rate"], pieces(arg, m)
    samples = max(rate, -(-max(lens) // rate) * rate)
    return [{"rows": batch_rows(len(lens)), "samples": samples,
             "frames": work.w2v2_frames(m, samples), "pieces": lens}]


def control(program: Program) -> None:
    """The embedder's rows computed by the port's int8 encoder of the same
    weights (``models/wav2vec2_quant.py``), pool and norm as before."""
    from mmer_tpu_torch.models.wav2vec2_quant import (quant_w2v2_embed,
                                                      quantize_w2v2_params)

    emb = program.target
    qparams = quantize_w2v2_params(emb.model)
    emb.embed_rows = lambda waves, mask: quant_w2v2_embed(qparams, emb.model,
                                                          waves, mask)
