"""``AudioEmbedder.embed_batch`` of ``mmer_tpu_torch`` over a WavLM
configuration: the Wav2Vec2 system's entry, pieces and forwards, with
``WavLMConfig`` and the position gate's operations."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.systems import Program
from benchmark.systems.wav2vec2 import control, forwards, pieces, useful  # noqa: F401
from mmer_tpu_torch.config import WavLMConfig
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder


def port_config(config: dict) -> WavLMConfig:
    return WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["model"].items()})


def build(config: dict, traffic: dict, state: dict,
          device: torch.device) -> Program:
    emb = AudioEmbedder(port_config(config), device=device, params=state,
                        **config["route"])
    return Program(call=emb.embed_batch, target=emb)


def piece_flops(m: dict, n_samples: int) -> int:
    """The Wav2Vec2 encoder's operations over one piece, and each layer's
    position gate, ``2·T·d·8`` (a head's slice through its 8 outputs)."""
    t = work.w2v2_frames(m, n_samples)
    return (work.w2v2_piece_flops(m, n_samples)
            + m["num_layers"] * 2 * t * m["hidden_dim"] * 8)


def flops(arg, config: dict) -> float:
    m = config["model"]
    return float(sum(piece_flops(m, n) for n in pieces(arg, m)))
