"""int8 GEMM rates at the ViViT and Wav2Vec2 GEMM shapes, the port of
``scripts/probe_int8.py``.

    python3 -m mmer_tpu_torch.scripts.probe_int8 [--device cuda]

The JAX script's six shapes (ViViT at B = 16: 25,088 tokens through the FFN,
q/k/v and attention-out GEMMs and a 3,072-deep patch GEMM; the Wav2Vec2
FFN's first GEMM at 64 x 199 frames), each in four legs:

1. ``bf16``: ``torch.matmul`` of bf16 operands (bf16 out), the float route's
   product;
2. ``int8_kernel``: ``qdot_int8`` on rows quantized beforehand, the
   ``csrc/qdot.cu`` GEMM **with its dequantize epilogue** (float32 out);
3. ``int8_dynamic``: ``qdot`` on float32 rows, ``row_quant`` and the GEMM:
   what the int8 forwards pay a product;
4. ``int_mm``: ``torch._int_mm`` (int32 out) and the dequantize as PyTorch
   operations, the library's yardstick, timed here and used nowhere.

Each leg prints ms, TOP/s (2·M·K·N operations) and its share of the H100's
peak for its type (989 TFLOP/s bf16, 1,979 TOP/s int8), and its speedup over
the bf16 leg.  Timing: CUDA events after a warm-up pass, cycling over
distinct pre-staged inputs (``scripts/timing.py``).  ``--tiny`` rehearses
the control flow on the CPU at 128 rows with the plain versions (host clock;
no device numbers).
"""

from __future__ import annotations

import argparse
import sys

import torch

from mmer_tpu_torch.ops.quant import qdot, qdot_int8, quantize_weight, row_quant
from mmer_tpu_torch.scripts.timing import (INPUTS, PEAK_FLOPS, PEAK_INT8_OPS,
                                           ROUNDS, device_randn, resolve_device,
                                           timed_ms)

# (tag, M, K, N): the JAX script's shapes.  Its patch leg is the model's
# tubelet projection, 3 x 16 x 16 x 4 = 3,072 deep.
SHAPES = (("ffn1", 25088, 768, 3072), ("ffn2", 25088, 3072, 768),
          ("qkv", 25088, 768, 2304), ("outp", 25088, 768, 768),
          ("patch", 16 * 1568, 3072, 768), ("w2v2-ffn1", 12736, 1024, 4096))
# (tag, M, K, N, row dtype, bias): every GEMM of the two int8 forwards, ViViT-B
# at B = 16 and Wav2Vec2-large at 64 x 4 s, with the rows each is fed (the
# tubelet projection on uint8 pixels); chip_smoke.py phase 6c and
# compare_builds.py time the kernels there.
MODEL_GEMMS = (
    ("_vivit_qkv", 16 * 1569, 768, 2304, "float32", False),
    ("_vivit_out", 16 * 1569, 768, 768, "bfloat16", False),
    ("_vivit_ffn_in", 16 * 1569, 768, 3072, "float32", True),
    ("_vivit_ffn_out", 16 * 1569, 3072, 768, "float32", False),
    ("_w2v2_proj", 64 * 199, 512, 1024, "float32", True),
    ("_w2v2_qkv", 64 * 199, 1024, 3072, "float32", True),
    ("_w2v2_out", 64 * 199, 1024, 1024, "float32", False),
    ("_w2v2_ffn_in", 64 * 199, 1024, 4096, "float32", True),
    ("_w2v2_ffn_out", 64 * 199, 4096, 1024, "float32", False),
    ("_vivit_tubelets", 16 * 1568, 3072, 768, "uint8", True),
)
TINY_M = 128


def parse_args(argv, description: str):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; --tiny alone means cpu")
    p.add_argument("--tiny", action="store_true",
                   help="the CPU rehearsal at a small size")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device or ("cpu" if args.tiny else "cuda"))
    return args


def library_qdot(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                 ws: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` and the dequantize as PyTorch operations: the
    library's int8 product, a yardstick only."""
    return torch._int_mm(xq, wq).float() * xs * ws


def main(argv=None) -> list:
    args = parse_args(argv, __doc__.split("\n\n")[0])
    device = args.device
    n_inputs = 1 if args.tiny else INPUTS
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} ({name}), {n_inputs} inputs a leg", flush=True)
    rows = []
    with torch.inference_mode():
        for tag, m, k, n in SHAPES:
            m = TINY_M if args.tiny else m
            ops = 2.0 * m * k * n
            x32 = device_randn((m, k), torch.float32, device, 7 * m + k, n_inputs)
            w = device_randn((k, n), torch.float32, device, k + n, 1)[0]
            wq, ws = quantize_weight(w)
            w16 = w.to(torch.bfloat16)
            x16 = [x.to(torch.bfloat16) for x in x32]
            xq = [row_quant(x) for x in x32]
            legs = (("bf16", lambda a: torch.matmul(a, w16), x16, PEAK_FLOPS),
                    ("int8_kernel", lambda q, s: qdot_int8(q, s, wq, ws), xq,
                     PEAK_INT8_OPS),
                    ("int8_dynamic", lambda a: qdot(a, wq, ws), x32, PEAK_INT8_OPS),
                    ("int_mm", lambda q, s: library_qdot(q, s, wq, ws), xq,
                     PEAK_INT8_OPS))
            base = None
            for leg, fn, inputs, peak in legs:
                args_ = [a if isinstance(a, tuple) else (a,) for a in inputs]
                ms = timed_ms(fn, args_, device)
                base = base or ms
                rate = ops / (ms * 1e-3)
                row = {"name": f"{tag} {leg}", "shape": tag, "leg": leg, "m": m,
                       "k": k, "n": n, "ms": ms, "tops": rate / 1e12,
                       "peak_share": rate / peak, "speedup": base / ms,
                       "calls": (1 + ROUNDS) * len(args_), "device": name}
                note = (" (GEMM + dequantize epilogue, rows quantized "
                        "beforehand)" if leg == "int8_kernel" else
                        " (library yardstick)" if leg == "int_mm" else "")
                print(f"{tag:9s} ({m}x{k}x{n}) {leg:12s}: {ms:9.4f} ms "
                      f"{row['tops']:8.2f} TOP/s {100 * row['peak_share']:6.2f} % "
                      f"of {peak / 1e12:.0f}, {row['speedup']:5.2f}x bf16{note}",
                      flush=True)
                rows.append(row)
            del x32, x16, xq
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"{row['name']}: no time measured")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
