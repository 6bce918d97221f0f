"""Component-level ViViT-B profile, the port of ``scripts/profile_vivit.py``.

    python3 -m mmer_tpu_torch.scripts.profile_vivit [--device cuda]

B = 16 chunks of 32 RGB frames at 224x224 (S = 1,569 tokens, 12 layers, 12
heads of 64) with the JAX package's seeded weights, five legs:

1. ``model kernels``: the full forward on the kernel route (the attention
   and FFN kernels), the extraction path;
2. ``model plain``: the full forward on the plain route
   (``use_kernels=False``: plain attention and FFN, as the JAX script's
   ``use_flash=False``);
3. ``attention kernel``: ``flash_attention`` alone at the model's shape
   (B, 12, 1569, 64) bf16, one layer's call;
4. ``attention plain``: ``reference_attention`` alone at that shape;
5. ``model no attention``: the kernel route with attention replaced by the
   identity (``v``), everything but attention.

Each leg prints ms per call, TFLOP/s and its share of the H100's 989
TFLOP/s bf16 peak, and the device's busy ms per call and idle share from a
torch.profiler trace of one pass (``timing.device_work``).  Timing: CUDA
events after a warm-up pass, cycling over distinct pre-staged inputs.  A
leg that fails ends the run non-zero.  ``--device cpu --tiny`` rehearses the
control flow on a small config with the plain versions (host clock; no
device numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.models import vivit
from mmer_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from mmer_tpu_torch.scripts.profile_w2v2 import leg
from mmer_tpu_torch.scripts.timing import resolve_device

B = 16
TINY = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
            tubelet_size=4, dim=64, depth=2, heads=2, dim_head=64, mlp_dim=128)


def attn_flops(cfg: ViViTConfig, b: int) -> int:
    """One layer's two products, ``q kᵀ`` and ``p v``."""
    s = vivit.max_tokens(cfg)
    return b * cfg.heads * 4 * s * s * cfg.dim_head


def model_flops(cfg: ViViTConfig, b: int) -> int:
    """The tubelet projection and every layer's GEMMs and attention."""
    s, d, inner = vivit.max_tokens(cfg), cfg.dim, cfg.heads * cfg.dim_head
    ph, pw = cfg.patch_size
    patch_dim = cfg.tubelet_size * ph * pw * cfg.in_channels
    patches = s - (1 if cfg.pool == "cls" else 0)
    per_layer = 2 * s * (4 * d * inner + 2 * d * cfg.mlp_dim)
    return b * (2 * patches * patch_dim * d
                + cfg.depth * per_layer) + cfg.depth * attn_flops(cfg, b)


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
    cfg = ViViTConfig(**TINY) if args.tiny else ViViTConfig()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    b, s = args.batch, vivit.max_tokens(cfg)
    rng = np.random.default_rng(args.seed)
    h, w = cfg.image_size
    video = [(torch.from_numpy(rng.random((b, cfg.num_frames, h, w, cfg.in_channels),
                                          np.float32)).to(device),)
             for _ in range(args.inputs)]
    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    qkv = [tuple(torch.from_numpy(rng.normal(size=(b, cfg.heads, s, cfg.dim_head))
                                  .astype(np.float32)).to(device, dt)
                 for _ in range(3)) for _ in range(args.inputs)]
    print(f"device={device} B={b} S={s} heads={cfg.heads} depth={cfg.depth} "
          f"{cfg.compute_dtype}, {args.inputs} inputs", flush=True)
    kernels = vivit.init_vivit(cfg, device=device)
    plain = vivit.init_vivit(cfg, device=device, use_kernels=False)
    full, attn = model_flops(cfg, b), attn_flops(cfg, b)
    rows = []
    with torch.inference_mode():
        rows.append(leg("model kernels", kernels, video, full, device))
        rows.append(leg("model plain", plain, video, full, device))
        rows.append(leg("attention kernel", flash_attention, qkv, attn, device))
        rows.append(leg("attention plain", reference_attention, qkv, attn, device))
        saved = vivit.flash_attention
        vivit.flash_attention = lambda q, k, v: v
        try:
            rows.append(leg("model no attention", kernels, video,
                            full - cfg.depth * attn, device))
        finally:
            vivit.flash_attention = saved
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"leg {row['name']}: no time measured")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
