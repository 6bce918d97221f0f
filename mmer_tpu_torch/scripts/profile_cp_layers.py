"""Per-layer times of the conv encoder's per-layer kernels, the port of
``scripts/profile_cp_layers.py``.

    python3 -m mmer_tpu_torch.scripts.profile_cp_layers [--device cuda]

B = 64 clips of N_PAD = 64,000 samples, the JAX package's seeded conv
weights, each layer on its own inputs generated on the device (seeded
``torch.Generator``): layer 0 (kernel 10, stride 5) as patches of 16 taps
through ``_call_gemm`` (``gemm0_ln_gelu_kernel``), the kernel-3 layers
through ``_call_k3`` (``k3_ln_gelu_kernel``) and the kernel-2 layers through
``_call_gemm`` (``gemm_ln_gelu_kernel``), on the stride-merged view
``fused_conv_encoder(mega=False)`` gives them.  Each layer prints its padded
output rows, ms, TFLOP/s and its bound (the larger of its operations at the
bf16 peak and its bytes, the input, weights and vectors read and the output
written once, at the memory rate).  Timing: CUDA events after a warm-up
pass, cycling over distinct inputs.  ``--device cpu --tiny`` rehearses the
control flow on a small config with the plain versions (host clock).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from mmer_tpu_torch.config import Wav2Vec2Config, torch_dtype
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
from mmer_tpu_torch.ops import conv_pyramid as cp
from mmer_tpu_torch.scripts.profile_w2v2 import TINY
from mmer_tpu_torch.scripts.timing import (INPUTS, bound_ms, device_randn,
                                           resolve_device, tensor_bytes,
                                           timed_row)

B = 64
TINY_B = 2
N_PAD = 64000


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
    dt = torch_dtype(cfg)
    enc = AudioEmbedder(cfg, device=device, use_kernels=False).model.feature_encoder
    b, n_inputs = (TINY_B, 1) if args.tiny else (B, INPUTS)
    print(f"device={device} B={b} samples={N_PAD} {cfg.compute_dtype}, "
          f"{n_inputs} inputs a layer", flush=True)

    rows = []

    def time_layer(name, fn, xs, w_bytes, c, t_pad, flops):
        print(f"{name}: t={t_pad:6d}", flush=True)
        out = fn(xs[0])
        bms, by = bound_ms(flops, tensor_bytes(xs[0], out) + w_bytes + 3 * c * 4)
        row = timed_row(name, fn, [(x,) for x in xs], flops, device,
                        bound_ms=bms)
        rows.append({**row, "bound_by": by, "t_pad": t_pad,
                     "calls": row["calls"] + 1})      # and the bound's call

    with torch.inference_mode():
        conv, ln = enc.convs[0], enc.norms[0]
        k0, s0 = cfg.conv_kernels[0], cfg.conv_strides[0]
        c = conv.weight.shape[0]
        t = (N_PAD - k0) // s0 + 1
        t_pad = cp._round_up(t, 2)
        kp = cp._round_up(k0, 16)
        w0 = torch.nn.functional.pad(conv.weight[:, 0, :].t(),
                                     (0, 0, 0, kp - k0)).to(dt).contiguous()
        patches = device_randn((b, t_pad, kp), dt, device, 0, n_inputs)
        time_layer(f"L0 (k{k0})", lambda x, tp=t_pad: cp._call_gemm(
            x, w0, conv.bias, ln.weight, ln.bias, tp), patches,
            tensor_bytes(w0), c, t_pad, 2 * b * t_pad * kp * c)
        del patches
        for i in range(1, len(cfg.conv_dims)):
            conv, ln = enc.convs[i], enc.norms[i]
            c, c_in, k = conv.weight.shape
            t_in_pad = t_pad
            t = (t - k) // 2 + 1
            t_pad = cp._round_up(t, 2)
            w = conv.weight.permute(2, 1, 0).to(dt).contiguous()   # (k, c_in, c)
            w01 = w[:2].reshape(2 * c_in, c)
            xms = device_randn((b, t_in_pad // 2, 2 * c_in), dt, device,
                               100 * i, n_inputs)
            if k == 2:
                fn = (lambda xm, tp=t_pad, w01=w01, conv=conv, ln=ln:
                      cp._call_gemm(xm, w01, conv.bias, ln.weight, ln.bias, tp))
            else:
                fn = (lambda xm, tp=t_pad, w01=w01, w2=w[2], conv=conv, ln=ln:
                      cp._call_k3(xm, w01, w2, conv.bias, ln.weight, ln.bias, tp))
            time_layer(f"L{i} (k{k})", fn, xms, tensor_bytes(w), c, t_pad,
                       2 * b * t_pad * k * c_in * c)
            del xms
    for row in rows:
        if not row["ms"] > 0:
            raise RuntimeError(f"layer {row['name']}: no time measured")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
