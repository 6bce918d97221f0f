"""Component-level Wav2Vec2-large profile at the extraction shape, the port of
``scripts/profile_w2v2.py``.

    python3 -m mmer_tpu_torch.scripts.profile_w2v2 [--device cuda]

B = 64 clips of 3.2 s, padded to the 4 s bucket (64,000 samples, 199
frames, 159 of them real), on the default route (the conv encoder kernel,
the FFN kernel, plain attention) with the JAX package's seeded weights.
Three legs:

1. ``full``: the whole default route with the length-masked pool and L2
   norm (``AudioEmbedder.embed_rows``), the production path;
2. ``conv encoder``: the 7-layer conv feature encoder alone
   (``fused_conv_encoder``);
3. ``transformer``: the rest alone (projection, positional conv, 24
   layers, final norm; ``Wav2Vec2Encoder.encode_frames``), fed
   precomputed frame features.

Each leg prints ms per call, TFLOP/s and its share of the H100's 989
TFLOP/s bf16 peak, and the device's busy ms per call and idle share from a
torch.profiler trace of one pass (``timing.device_work``): the time a leg
spends outside kernels, on the host or in gaps.  Timing: CUDA events after a
warm-up pass, cycling over distinct pre-staged inputs.  A leg that fails
ends the run non-zero.  ``--device cpu --tiny`` rehearses the control flow
on a small config with the plain versions (host clock; no device numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder, feat_extract_output_length
from mmer_tpu_torch.scripts.timing import (ROUNDS, TRACE_ATTEMPTS, device_work,
                                           rate_row, resolve_device, timed_ms)

B, CLIP_S = 64, 3.2
TINY = dict(hidden_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
            conv_dims=(32,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)


def conv_flops(cfg: Wav2Vec2Config, n_samples: int) -> int:
    """Multiply-adds x 2 of the conv encoder for one clip of ``n_samples``."""
    flops, length, c_in = 0, n_samples, 1
    for dim, k, s in zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides):
        length = (length - k) // s + 1
        flops += 2 * length * dim * k * c_in
        c_in = dim
    return flops


def transformer_flops(cfg: Wav2Vec2Config, t: int) -> int:
    """The projection, the grouped positional conv and the layers (q, k, v,
    out, the FFN and attention's two products) for one clip of ``t``
    frames."""
    d, f = cfg.hidden_dim, cfg.ffn_dim
    per_layer = 2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d
    pos_conv = (2 * t * d * (d // cfg.num_conv_pos_embedding_groups)
                * cfg.num_conv_pos_embeddings)
    return cfg.num_layers * per_layer + pos_conv + 2 * t * cfg.conv_dims[-1] * d


def leg(name: str, fn, inputs, flops: float, device: torch.device) -> dict:
    """One leg's row: ms per call, rate, and on a card the device's busy
    ms per call and idle share over one traced pass of the inputs
    (``device_work``: a warm-up pass and the recorded one).  On an H100 a
    trace now and then misses kernels that ran, and never shows one that
    did not, so the leg traces ``TRACE_ATTEMPTS`` passes and keeps the one
    with the most device operations.  ``calls`` counts the calls of ``fn``
    the leg made."""
    ms = timed_ms(fn, inputs, device)
    calls = (1 + ROUNDS) * len(inputs)
    extra = {}
    if device.type == "cuda":
        busy, ops = 0.0, 0
        for _ in range(TRACE_ATTEMPTS):
            traced = device_work(lambda: [fn(*a) for a in inputs], device)
            calls += 2 * len(inputs)
            if traced[1] > ops:
                busy, ops = traced
        if not ops:
            raise RuntimeError(f"leg {name}: {TRACE_ATTEMPTS} traced passes "
                               "showed no device work")
        busy /= len(inputs)
        extra = {"device_busy_ms": busy, "idle_share": 1.0 - busy / ms,
                 "device_ops": ops / len(inputs)}
    return {**rate_row(name, ms, flops, device, **extra), "calls": calls}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a small config (the CPU rehearsal)")
    p.add_argument("--inputs", type=int, default=3,
                   help="distinct pre-staged batches to cycle over")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = Wav2Vec2Config(**TINY) if args.tiny else Wav2Vec2Config()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    emb = AudioEmbedder(cfg, device=device)
    model = emb.model
    n = int(cfg.sample_rate * CLIP_S)
    n_pad = emb._bucket_len(n)
    t_out = feat_extract_output_length(cfg, n_pad)
    frames = feat_extract_output_length(cfg, n)
    b = args.batch
    rng = np.random.default_rng(args.seed)
    mask = torch.from_numpy(np.broadcast_to(np.arange(t_out) >= frames,
                                            (b, t_out)).copy()).to(device)
    waves = [torch.from_numpy(np.pad(rng.normal(size=(b, n)).astype(np.float32),
                                     ((0, 0), (0, n_pad - n)))).to(device)
             for _ in range(args.inputs)]
    feats = [torch.from_numpy(rng.normal(size=(b, t_out, cfg.conv_dims[-1])
                                         ).astype(np.float32)).to(device)
             for _ in range(args.inputs)]
    print(f"device={device} B={b} samples={n_pad} frames={t_out} "
          f"({frames} real) {cfg.compute_dtype}, {args.inputs} inputs",
          flush=True)
    c_fl, t_fl = b * conv_flops(cfg, n_pad), b * transformer_flops(cfg, t_out)
    with torch.inference_mode():
        rows = [leg("full", lambda w: emb.embed_rows(w, mask),
                    [(w,) for w in waves], c_fl + t_fl, device),
                leg("conv encoder", model.feature_encoder,
                    [(w,) for w in waves], c_fl, device),
                leg("transformer", lambda f: model.encode_frames(f, mask),
                    [(f,) for f in feats], t_fl, device)]
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"leg {row['name']}: no time measured")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
