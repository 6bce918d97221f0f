"""int8-GEMM ViViT against the bf16 kernel route, the port of
``scripts/probe_int8_vivit.py``.

    python3 -m mmer_tpu_torch.scripts.probe_int8_vivit [--device cuda]

ViViT-B with the JAX package's seeded weights at B = 16 on distinct seeded
uint8 (16, 32, 224, 224, 3) batches drawn on the device, three legs:

1. ``bf16``: ``ViViTFeatureExtractor`` on the kernel route (attention and
   FFN kernels) on the frames scaled by 1/255, as the extractor feeds it;
2. ``int8-flash``: ``quant_vivit_apply`` on the uint8 frames, the int8
   products of ``csrc/qdot.cu`` and the attention kernel;
3. ``int8-plain-attn``: the same int8 products with plain attention (JAX's
   ``use_flash=False`` leg).

Each leg prints ms, chunks/s, TOP/s and its speedup over ``bf16``; each int8
leg its cosine and rel-L2 against ``bf16`` a chunk, and its largest rel-L2
a chunk against the int8 forward's plain route (``use_kernels=False``: the
plain products and attention) on the first batch.  Timing: CUDA events after
a warm-up pass, cycling over the batches (``scripts/timing.py``).
``--tiny`` rehearses the control flow on the CPU on a small config with
the plain versions (host clock; no device numbers).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.models.vivit import init_vivit
from mmer_tpu_torch.models.vivit_quant import quant_vivit_apply, quantize_vivit_params
from mmer_tpu_torch.scripts.probe_int8 import parse_args
from mmer_tpu_torch.scripts.profile_vivit import TINY, model_flops
from mmer_tpu_torch.scripts.timing import INPUTS, ROUNDS, timed_ms

B = 16
TINY_B = 2


def agreement(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Cosine and rel-L2 of each row of ``got`` against ``ref``."""
    got, ref = got.float(), ref.float()
    cos = (got * ref).sum(1) / (got.norm(dim=1) * ref.norm(dim=1)).clamp_min(1e-12)
    rel = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-12)
    return {"cos_min": float(cos.min()), "cos_max": float(cos.max()),
            "rel_l2_mean": float(rel.mean()), "rel_l2_max": float(rel.max())}


def run_legs(legs, inputs: list, plain: torch.Tensor, ops: float, b: int,
             unit: str, device: torch.device, name: str) -> list:
    """Times each ``(leg, fn)`` of ``legs`` over ``inputs`` (the first leg
    the baseline); a row a leg with ms, ``<unit>_per_s``, TOP/s, the speedup
    over the first leg, ``calls`` (the timed passes and one comparison call)
    and, after the first, the agreement of its output on ``inputs[0]`` with
    the first leg's and its largest rel-L2 a row from ``plain``."""
    rows, ref, base = [], None, None
    for leg, fn in legs:
        ms = timed_ms(fn, [(x,) for x in inputs], device)
        out = fn(inputs[0])
        base = base or ms
        row = {"name": leg, "ms": ms, f"{unit}_per_s": b / (ms * 1e-3),
               "tops": ops / (ms * 1e-3) / 1e12, "speedup": base / ms,
               "calls": (1 + ROUNDS) * len(inputs) + 1, "device": name,
               "finite": bool(torch.isfinite(out).all())}
        if ref is None:
            ref = out
        else:
            row.update(agreement(out, ref))
            row["plain_route_rel_l2"] = agreement(out, plain)["rel_l2_max"]
        print(f"{leg:16s}: {ms:9.3f} ms {row[f'{unit}_per_s']:7.1f} {unit}/s "
              f"{row['tops']:7.2f} TOP/s  {row['speedup']:4.2f}x {legs[0][0]}"
              + (f"  vs {legs[0][0]}: cos {row['cos_min']:.5f}..{row['cos_max']:.5f}"
                 f" rel-L2 {row['rel_l2_mean']:.4f} (max {row['rel_l2_max']:.4f});"
                 f" vs the plain route: rel-L2 {row['plain_route_rel_l2']:.2e}"
                 if "cos_min" in row else ""), flush=True)
        if not (ms > 0 and row["finite"]):
            raise RuntimeError(f"leg {leg}: no time measured or non-finite output")
        rows.append(row)
    return rows


def main(argv=None) -> list:
    args = parse_args(argv, __doc__.split("\n\n")[0])
    device = args.device
    cfg = ViViTConfig(**TINY) if args.tiny else ViViTConfig()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    b, n_inputs = (TINY_B, 1) if args.tiny else (B, INPUTS)
    h, w = cfg.image_size
    gen = torch.Generator(device=device)
    batches = []
    for i in range(n_inputs):
        gen.manual_seed(i)
        batches.append(torch.randint(0, 256, (b, cfg.num_frames, h, w,
                                              cfg.in_channels), generator=gen,
                                     device=device, dtype=torch.uint8))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} ({name}) B={b} {cfg.compute_dtype}, {n_inputs} "
          "inputs", flush=True)
    model = init_vivit(cfg, device=device)
    qp = quantize_vivit_params(model)
    legs = (("bf16", lambda v: model(v.float() / 255.0)),
            ("int8-flash", lambda v: quant_vivit_apply(qp, v, cfg)),
            ("int8-plain-attn",
             lambda v: quant_vivit_apply(qp, v, cfg, use_flash=False)))
    with torch.inference_mode():
        plain = quant_vivit_apply(qp, batches[0], cfg, use_kernels=False)
        return run_legs(legs, batches, plain, model_flops(cfg, b), b, "chunks",
                        device, name)


if __name__ == "__main__":
    main(sys.argv[1:])
