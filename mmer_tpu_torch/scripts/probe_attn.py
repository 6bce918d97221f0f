"""Where does the ViViT attention kernel's time go?  The counterpart of
``scripts/probe_attn.py``.

    python3 -m mmer_tpu_torch.scripts.probe_attn [--device cuda]

Times the seven modes of :mod:`mmer_tpu_torch.ops.attention_variants` at the
ViViT shape (B=16, H=12, S=1569 zero-padded to 1664, D=64, bf16) through one
harness: ms per launch, TFLOP/s and the share of the H100's 989 TFLOP/s bf16
peak (all modes are charged the same 4·B·H·S²·D operations), and for the four
valid modes the largest difference from :func:`flash_attention`.

  full → nosoftmax   everything the softmax costs on top of the two products;
  noexp              places exp within that;
  nomask             what the key bounds check costs;
  mxumask            whether masking inside the first product is free;
  kt, kt_nosoftmax   what the K layout costs.

Each launch is timed alone (CUDA events after warm-up) over pre-staged
operands: pads, transposes and the 65th columns are made once, outside the
timed region.  ``--device cpu --tiny`` rehearses the control flow with the
plain versions (host clock: not a device time).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mmer_tpu_torch.ops.attention_variants import (MODES, VALID_MODES,
                                                   attention_variant,
                                                   launch_variant,
                                                   variant_operands)
from mmer_tpu_torch.ops.flash_attention import flash_attention
from mmer_tpu_torch.scripts.timing import rate_row, resolve_device, timed_ms

B, H, S, D, S_PAD = 16, 12, 1569, 64, 1664
TINY = (2, 2, 50, 64, 64)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="small shapes (the CPU rehearsal)")
    p.add_argument("--inputs", type=int, default=3,
                   help="distinct pre-staged (q, k, v) sets to cycle over")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    b, h, s, d, s_pad = TINY if args.tiny else (B, H, S, D, S_PAD)
    rng = np.random.default_rng(args.seed)
    print(f"device={device} B={b} H={h} S={s} (padded to {s_pad}) D={d} bf16, "
          f"{args.inputs} inputs", flush=True)
    qkvs = [tuple(torch.from_numpy(
        rng.normal(size=(b, h, s, d)).astype(np.float32)).to(device, torch.bfloat16)
        for _ in range(3)) for _ in range(args.inputs)]
    flops = 4.0 * b * h * s * s * d
    on_card = device.type == "cuda"

    ref = flash_attention(*qkvs[0]).float()
    rows = []
    for mode in MODES:
        if on_card:
            staged = [variant_operands(*qkv, mode, s_pad) for qkv in qkvs]

            def fn(q, k, v, mode=mode):
                return launch_variant(mode, q, k, v, s_pad)
        else:
            staged = qkvs

            def fn(q, k, v, mode=mode):
                return attention_variant(q, k, v, mode, s_pad)
        extra = {}
        if mode in VALID_MODES:
            extra["max_abs_diff_vs_flash"] = float(
                (fn(*staged[0]).float() - ref).abs().max())
        rows.append(rate_row(mode, timed_ms(fn, staged, device), flops, device,
                             **extra))
        del staged
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
