"""The Wav2Vec2 conv encoder on its three routes at the extraction shape, and
the whole model's effect, the port of ``scripts/profile_conv_pyramid.py``.

    python3 -m mmer_tpu_torch.scripts.profile_conv_pyramid [--device cuda]

B = 64 clips of 3.2 s, padded to the 4 s bucket (64,000 samples), with the
JAX package's seeded weights.  Legs:

1. ``conv plain``: ``ConvFeatureEncoder(use_kernels=False)``, the plain
   PyTorch version;
2. ``conv layers``: the per-layer kernel route (``mega=False``:
   ``_call_gemm`` for layer 0 and the kernel-2 layers, ``_call_k3`` for the
   kernel-3 layers);
3. ``conv mega``: the whole-pyramid route (``fused_conv_encoder``, a launch
   a layer);
4. ``full plain`` / ``full kernels``: ``AudioEmbedder.embed_rows`` on the
   plain route and on the default kernel route, in clips/s.

Each conv leg prints ms, TFLOP/s and its share of the H100's 989 TFLOP/s
bf16 peak, its bound (the larger of its operations at that peak and its
bytes at the memory rate: the waveform read, the frames written and the
params read once) and the max |Δ| of ``[:2, :64]`` against the plain leg.
Timing: CUDA events after a warm-up pass, cycling over distinct pre-staged
inputs.  ``--device cpu --tiny`` rehearses the control flow on a small config
with the plain versions (host clock; no device numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder, ConvFeatureEncoder
from mmer_tpu_torch.scripts.profile_w2v2 import TINY, transformer_flops
from mmer_tpu_torch.scripts.timing import (INPUTS, bound_ms, resolve_device,
                                           tensor_bytes, timed_row)

B = 64
TINY_B = 2
CLIP_S = 3.2


def conv_flops(cfg, n_samples):
    """(multiply-adds x 2 of the conv encoder for one clip of ``n_samples``,
    its output frames)."""
    fl, length, in_ch = 0, n_samples, 1
    for dim, k, s in zip(cfg.conv_dims, cfg.conv_kernels, cfg.conv_strides):
        length = (length - k) // s + 1
        fl += 2 * length * dim * k * in_ch
        in_ch = dim
    return fl, length


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a small config (the CPU rehearsal)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = Wav2Vec2Config(**TINY) if args.tiny else Wav2Vec2Config()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    plain_emb = AudioEmbedder(cfg, device=device, use_kernels=False)
    kernel_emb = AudioEmbedder(cfg, device=device,
                               params=plain_emb.model.state_dict())
    weights = plain_emb.model.feature_encoder.state_dict()
    convs = {}
    for name, kw in (("plain", dict(use_kernels=False)),
                     ("layers", dict(mega=False)), ("mega", dict(mega=True))):
        convs[name] = ConvFeatureEncoder(cfg, device=device, **kw)
        convs[name].load_state_dict(weights)

    b, n_inputs = (TINY_B, 1) if args.tiny else (B, INPUTS)
    n = int(cfg.sample_rate * CLIP_S)
    n_pad = plain_emb._bucket_len(n)
    rng = np.random.default_rng(0)
    waves = [torch.from_numpy(np.pad(rng.normal(size=(b, n)).astype(np.float32),
                                     ((0, 0), (0, n_pad - n)))).to(device)
             for _ in range(n_inputs)]
    c_fl, t_frames = conv_flops(cfg, n_pad)
    fl = b * c_fl
    print(f"device={device} B={b} samples={n_pad} frames={t_frames} "
          f"{cfg.compute_dtype}, {n_inputs} inputs", flush=True)

    rows = []
    with torch.inference_mode():
        ref = convs["plain"](waves[0])[:2, :64].float()
        for name, enc in convs.items():
            out = enc(waves[0])
            err = float((out[:2, :64].float() - ref).abs().max())
            bms, by = bound_ms(fl, tensor_bytes(waves[0], out,
                                                *enc.state_dict().values()))
            rows.append(timed_row(f"conv {name}", enc, [(w,) for w in waves],
                                  fl, device, max_abs_diff=err, bound_ms=bms))
            rows[-1]["bound_by"] = by
            rows[-1]["calls"] += 1               # the comparison call
            del out
        # The whole model, every frame real, as the JAX script feeds it.
        mask = torch.zeros((b, t_frames), dtype=torch.bool, device=device)
        for name, emb in (("plain", plain_emb), ("kernels", kernel_emb)):
            row = timed_row(f"full {name}", lambda w, e=emb: e.embed_rows(w, mask),
                            [(w,) for w in waves],
                            fl + b * transformer_flops(cfg, t_frames), device)
            row["clips_per_s"] = b / (row["ms"] * 1e-3)
            print(f"full model ({name:7s}): {row['ms']:9.4f} ms  "
                  f"{row['clips_per_s']:8.1f} clips/s", flush=True)
            rows.append(row)
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"leg {row['name']}: no time measured")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
