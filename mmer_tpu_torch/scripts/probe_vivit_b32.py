"""ViViT batch-size A/B: B = 16 (the extraction default) against B = 32, the
port of ``scripts/probe_vivit_b32.py``.

    python3 -m mmer_tpu_torch.scripts.probe_vivit_b32 [--device cuda]

``ViViTFeatureExtractor`` on the kernel route (the attention and FFN
kernels) with the JAX package's seeded weights, on distinct unit-normal
(B, 32, 224, 224, 3) inputs drawn on the device (seeded
``torch.Generator``).  Each batch size prints ms, chunks/s, TFLOP/s and its
share of the H100's 989 TFLOP/s bf16 peak.  Timing: CUDA events after a
warm-up pass, cycling over the inputs.  ``--device cpu --tiny`` rehearses
the control flow on a small config with the plain versions (host clock).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.models.vivit import init_vivit
from mmer_tpu_torch.scripts.profile_vivit import TINY, model_flops
from mmer_tpu_torch.scripts.timing import (INPUTS, device_randn, resolve_device,
                                           timed_row)

BATCHES = (16, 32)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a small config (the CPU rehearsal)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ViViTConfig(**TINY) if args.tiny else ViViTConfig()
    n_inputs = 1 if args.tiny else INPUTS
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = init_vivit(cfg, device=device)
    h, w = cfg.image_size
    print(f"device={device} {cfg.compute_dtype}, {n_inputs} inputs a batch "
          "size", flush=True)
    rows = []
    with torch.inference_mode():
        for b in BATCHES:
            video = device_randn((b, cfg.num_frames, h, w, cfg.in_channels),
                                 torch.float32, device, 1000 * b, n_inputs)
            row = timed_row(f"B={b}", model, [(v,) for v in video],
                            model_flops(cfg, b), device, batch=b)
            row["chunks_per_s"] = b / (row["ms"] * 1e-3)
            print(f"B={b:2d}: {row['ms']:9.4f} ms {row['chunks_per_s']:7.1f} "
                  "chunks/s", flush=True)
            rows.append(row)
            del video
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"{row['name']}: no time measured")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
