"""Kernel-level A/B: the fused-block CUDA kernels against library calls at the
ViViT-B production shape (B=16, S=1569, D=768, M=3072, N_QKV=2304, bf16); the
counterpart of ``scripts/profile_fused_blocks.py``.

    python3 -m mmer_tpu_torch.scripts.profile_fused_blocks [--device cuda]

Four lines, ms per call, TFLOP/s and the share of the H100's 989 TFLOP/s bf16
peak: ``LN+QKV plain`` (``F.layer_norm`` + ``F.linear`` in bf16, two library
calls), ``LN+QKV fused`` (:func:`fused_ln_matmul`), ``FFN plain`` (LayerNorm,
two ``F.linear`` and a GELU in bf16) and ``FFN fused`` (:func:`fused_ffn`).

Timing: CUDA events after warm-up, cycling over distinct pre-staged inputs
that together exceed the L2 cache.  The JAX script chains twelve layers inside
one jit to hide its relay's dispatch round trip; a CUDA launch has no such
cost, so each call is timed as it is.  ``--device cpu --tiny`` rehearses the
control flow on small shapes with the kernels' plain versions (host clock:
not a device time).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from mmer_tpu_torch.ops.fused_blocks import LN_EPS, fused_ffn, fused_ln_matmul
from mmer_tpu_torch.scripts.timing import rate_row, resolve_device, timed_ms

B, S, D, M, N_QKV = 16, 1569, 768, 3072, 2304
TINY = (2, 37, 64, 128, 192)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="small shapes (the CPU rehearsal)")
    p.add_argument("--inputs", type=int, default=4,
                   help="distinct pre-staged activations to cycle over")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    b, s, d, m, n = TINY if args.tiny else (B, S, D, M, N_QKV)
    rng = np.random.default_rng(args.seed)
    bf = torch.bfloat16

    def dev(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    xs = [(dev(rng.normal(size=(b, s, d)), bf),) for _ in range(args.inputs)]
    scale = dev(rng.normal(size=(d,)) * 0.1 + 1, torch.float32)
    bias = dev(rng.normal(size=(d,)) * 0.1, torch.float32)
    w_qkv = dev(rng.normal(size=(n, d)) * 0.02, bf)
    w1 = dev(rng.normal(size=(m, d)) * 0.02, bf)
    b1 = dev(rng.normal(size=(m,)) * 0.1, torch.float32)
    w2 = dev(rng.normal(size=(d, m)) * 0.02, bf)
    b2 = dev(rng.normal(size=(d,)) * 0.1, torch.float32)
    scale_bf, bias_bf, b1_bf, b2_bf = (t.to(bf) for t in (scale, bias, b1, b2))
    print(f"device={device} B={b} S={s} D={d} M={m} N_QKV={n} bf16, "
          f"{args.inputs} inputs", flush=True)

    def ln(x):
        return F.layer_norm(x, (d,), scale_bf, bias_bf, LN_EPS)

    def qkv_plain(x):
        return F.linear(ln(x), w_qkv)

    def qkv_fused(x):
        return fused_ln_matmul(x, scale, bias, w_qkv)

    def ffn_plain(x):
        return x + F.linear(F.gelu(F.linear(ln(x), w1, b1_bf)), w2, b2_bf)

    def ffn_fused(x):
        return fused_ffn(x, scale, bias, w1, b1, w2, b2)

    tokens = b * s
    rows = []
    for name, fn, flops in (
            ("LN+QKV plain", qkv_plain, 2.0 * tokens * d * n),
            ("LN+QKV fused", qkv_fused, 2.0 * tokens * d * n),
            ("FFN plain", ffn_plain, 4.0 * tokens * d * m),
            ("FFN fused", ffn_fused, 4.0 * tokens * d * m)):
        rows.append(rate_row(name, timed_ms(fn, xs, device), flops, device))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
