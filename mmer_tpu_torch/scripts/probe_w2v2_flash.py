"""Wav2Vec2 attention A/B: plain attention against the varlen flash kernel,
the port of ``scripts/probe_w2v2_flash.py``.

    python3 -m mmer_tpu_torch.scripts.probe_w2v2_flash [--device cuda]

The full ``Wav2Vec2Encoder`` (B = 64 x 64,000 samples, the extraction
shape) with the JAX package's seeded weights, the conv encoder and FFN
kernels on, a frame mask that pads the last quarter of the frames of a
quarter of the clips (the key-length path), attention plain
(``use_flash_attn=False``, the default: on the card the plain-attention
kernel, ``ops/plain_attention.py``) against ``use_flash_attn=True``.
Each variant prints ms, clips/s, TFLOP/s and its share of the H100's 989
TFLOP/s bf16 peak; then the max |Δ| over the sampled rows ``[:, :4, :8]``
and the largest relative L2 distance of a clip's output.  Timing: CUDA
events after a warm-up pass, cycling over distinct pre-staged inputs.
``--device cpu --tiny`` rehearses the control flow on a small config with
the plain versions (host clock; no device numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.wav2vec2 import (Wav2Vec2Encoder,
                                            feat_extract_output_length,
                                            init_wav2vec2)
from mmer_tpu_torch.scripts.profile_w2v2 import TINY
from mmer_tpu_torch.scripts.timing import INPUTS, resolve_device, timed_row

B, SAMPLES = 64, 64000
TINY_B = 4


def model_flops(cfg, t, b=B, samples=SAMPLES):
    d, m, L = cfg.hidden_dim, cfg.ffn_dim, cfg.num_layers
    per_layer = (4 * d * d + 2 * d * m) * t * 2
    attn = 4 * t * t * (d // cfg.num_heads) * cfg.num_heads
    conv = 0
    length = samples
    in_ch = 1
    for ch, k, s in zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides):
        length = (length - k) // s + 1
        conv += 2 * length * ch * in_ch * k
        in_ch = ch
    return b * (conv + L * (per_layer + attn))


def parse_args(argv, description: str):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a small config (the CPU rehearsal)")
    return p.parse_args(argv)


def encoder_ab(args, variants) -> list:
    """Times the encoder of each ``(name, Wav2Vec2Encoder kwargs)`` of
    ``variants`` (the first the baseline, all on its weights) on the same
    padded batches; returns a row a variant, the last with the comparison
    to the first (``max_abs_diff`` over ``[:, :4, :8]``, ``clip_rel_l2_max``
    over every clip's output)."""
    device = resolve_device(args.device)
    cfg = Wav2Vec2Config(**TINY) if args.tiny else Wav2Vec2Config()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    b, n_inputs = (TINY_B, 1) if args.tiny else (B, INPUTS)
    t = feat_extract_output_length(cfg, SAMPLES)
    print(f"device={device} B={b} samples={SAMPLES} frames={t} "
          f"{cfg.compute_dtype}, {n_inputs} inputs", flush=True)
    rng = np.random.default_rng(0)
    waves = [torch.from_numpy(rng.normal(size=(b, SAMPLES)).astype(np.float32)
                              ).to(device) for _ in range(n_inputs)]
    # A frame mask as extraction makes one, with a quarter of the batch short.
    pad = np.zeros((b, t), bool)
    pad[:b // 4, (3 * t) // 4:] = True
    pad = torch.from_numpy(pad).to(device)
    fl = model_flops(cfg, t, b)
    rows, outs, weights = [], [], None
    with torch.inference_mode():
        for name, kw in variants:
            if weights is None:
                model = init_wav2vec2(cfg, device=device, **kw)
                weights = model.state_dict()
            else:
                model = Wav2Vec2Encoder(cfg, device=device, **kw).eval()
                model.load_state_dict(weights)
            row = timed_row(name, lambda w, m=model: m(w, pad),
                            [(w,) for w in waves], fl, device)
            row["clips_per_s"] = b / (row["ms"] * 1e-3)
            print(f"{name}: {row['ms']:9.4f} ms  {row['clips_per_s']:8.1f} "
                  "clips/s", flush=True)
            outs.append(model(waves[0], pad).float())
            row["calls"] += 1                    # the comparison call
            rows.append(row)
            del model
    a, z = outs[0], outs[-1]
    err = float((a[:, :4, :8] - z[:, :4, :8]).abs().max())
    rel = ((z - a).flatten(1).norm(dim=1)
           / a.flatten(1).norm(dim=1).clamp_min(1e-12)).max()
    rows[-1].update(max_abs_diff=err, clip_rel_l2_max=float(rel))
    print(f"max|Δ| (sampled rows): {err:.2e}; largest rel-L2 of a clip: "
          f"{float(rel):.3e}", flush=True)
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"variant {row['name']}: no time measured")
    return rows


def main(argv=None) -> list:
    args = parse_args(argv, __doc__.split("\n\n")[0])
    return encoder_ab(args, [("plain-attn", dict(use_flash_attn=False)),
                             ("flash-attn", dict(use_flash_attn=True))])


if __name__ == "__main__":
    main(sys.argv[1:])
