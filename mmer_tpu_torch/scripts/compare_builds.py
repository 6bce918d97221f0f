"""Two builds of the CUDA kernels on the same inputs: same bits or not, and
their times side by side.

    python3 -m mmer_tpu_torch.scripts.compare_builds --other DIR

``DIR`` is another ``csrc/`` directory, for example a parent commit's
(``git archive <commit> mmer_tpu_torch/csrc | tar -x -C build/parent``); the
other side is this package's ``csrc/``.  For each case the kernel's wrapper
runs on one set of seeded inputs with each build; the script reports whether
the two outputs are the same bits and times both in turns (other, this,
this, other: CUDA events after warm-up; for the conv encoder also each
layer's device time from a torch.profiler trace), one JSON line a case.  The
cases are the main paths' shapes: the conv encoder (``mega=True``) at the
serving waveform and the two extraction batches (also on its per-layer route,
``mega=False``), the per-layer route's kernel-3 layer
at 8000 / 4000 / 2000 / 1000 merged rows and its ``_call_gemm`` at the layer-0
and kernel-2 shapes of both extraction batches, ``fused_ln_matmul`` at the
profile and the Wav2Vec2 shapes (both routes of the encoder, ``_call_gemm``
and ``fused_ln_matmul`` also by device time from a torch.profiler trace), and one shape each of ``fused_ffn`` and ``flash_attention``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.ops import _build
from mmer_tpu_torch.ops.conv_pyramid import _call_gemm, _call_k3, fused_conv_encoder
from mmer_tpu_torch.ops.flash_attention import flash_attention
from mmer_tpu_torch.ops.fused_blocks import fused_ffn, fused_ln_matmul
from mmer_tpu_torch.scripts.timing import event_ms, kernel_device_ms

THIS = _build.CSRC
ITERS = 10                      # timed calls a turn, after warm-up
# Cases also timed by device time: a part of their kernels' names and the
# launches a call makes (each of the conv encoder's seven on both routes, the
# per-layer route's rows . W layer, the LN-matmul).
DEVICE_TIMED = {"fused_conv_encoder": ("ln_gelu_kernel", 7),
                "fused_conv_encoder(mega=False)": ("ln_gelu_kernel", 7),
                "conv_gemm_ln_gelu": ("gemm", 1), "fused_ln_matmul": ("ln_matmul_kernel", 1)}


def use(csrc: Path) -> None:
    """Route every later kernel call to the libraries built from ``csrc``."""
    _build.CSRC = Path(csrc)
    _build._libs.clear()
    _build._entries.clear()


def cases(dev):
    """(name, shape, call) for every case, each on inputs of its own seed."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    def vectors(n=512):
        return randn(n, std=0.1), 1.0 + randn(n, std=0.1), randn(n, std=0.1)

    cfg = Wav2Vec2Config()
    for seed, shape in enumerate(((4, 48000), (64, 80000), (64, 160000))):
        g.manual_seed(seed)
        c_in, conv = 1, []
        for dim, k in zip(cfg.conv_dims, cfg.conv_kernels):
            conv.append((randn(dim, c_in, k, std=(k * c_in) ** -0.5), *vectors(dim)))
            c_in = dim
        conv = [list(t) for t in zip(*conv)]
        wave = randn(*shape)
        yield ("fused_conv_encoder", f"wave {shape} f32",
               lambda wave=wave, conv=conv: fused_conv_encoder(wave, *conv, cfg))
        yield ("fused_conv_encoder(mega=False)", f"wave {shape} f32",
               lambda wave=wave, conv=conv: fused_conv_encoder(wave, *conv, cfg, mega=False))
    for seed, rows in enumerate((8000, 4000, 2000, 1000), start=10):
        g.manual_seed(seed)
        xm = randn(64, rows, 1024, dtype=bf)
        w01 = randn(1024, 512, std=1536 ** -0.5, dtype=bf)
        w2 = randn(512, 512, std=1536 ** -0.5, dtype=bf)
        vecs = vectors()
        yield ("conv_k3_ln_gelu", f"xm (64,{rows},1024) bf16",
               lambda a=(xm, w01, w2, *vecs), t=rows: _call_k3(*a, t))
    for seed, (rows, kdim) in enumerate(((16000, 16), (500, 1024), (32000, 16), (250, 1024),
                                         (1000, 1024)), start=20):
        g.manual_seed(seed)
        x = randn(64, rows, kdim, dtype=bf)
        w = randn(kdim, 512, std=kdim ** -0.5, dtype=bf)
        vecs = vectors()
        yield ("conv_gemm_ln_gelu", f"x (64,{rows},{kdim}) bf16",
               lambda a=(x, w, *vecs), t=rows: _call_gemm(*a, t))
    g.manual_seed(30)
    x = randn(16, 1569, 768, dtype=bf)
    ln = (1.0 + randn(768, std=0.1), randn(768, std=0.1))
    w = randn(2304, 768, std=768 ** -0.5, dtype=bf)
    yield ("fused_ln_matmul", "x (16,1569,768) bf16, w (2304,768)",
           lambda: fused_ln_matmul(x, *ln, w))
    g.manual_seed(33)
    x32 = randn(4, 149, 1024)
    ln32 = (1.0 + randn(1024, std=0.1), randn(1024, std=0.1))
    w32 = randn(3072, 1024, std=1024 ** -0.5, dtype=bf)
    yield ("fused_ln_matmul", "x (4,149,1024) f32, w (3072,1024)",
           lambda: fused_ln_matmul(x32, *ln32, w32))
    g.manual_seed(31)
    ffn = (randn(64, 249, 1024), 1.0 + randn(1024, std=0.1), randn(1024, std=0.1),
           randn(4096, 1024, std=1024 ** -0.5, dtype=bf), randn(4096, std=0.1, dtype=bf),
           randn(1024, 4096, std=4096 ** -0.5, dtype=bf), randn(1024, std=0.1, dtype=bf))
    yield ("fused_ffn", "x (64,249,1024) f32, M 4096", lambda: fused_ffn(*ffn))
    g.manual_seed(32)
    qkv = [randn(8, 12, 1569, 64, dtype=bf) for _ in range(3)]
    yield ("flash_attention", "q,k,v (8,12,1569,64) bf16", lambda: flash_attention(*qkv))


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, type=Path,
                   help="the other build's csrc/ directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_builds launches kernels: it needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = []
    try:
        for name, shape, call in cases(torch.device("cuda")):
            outs, ms, device_ms = {}, {"other": [], "this": []}, {"other": [], "this": []}
            for side, csrc in (("other", args.other), ("this", THIS)):
                use(csrc)
                outs[side] = call().clone()
            for side, csrc in (("other", args.other), ("this", THIS), ("this", THIS),
                               ("other", args.other)):
                use(csrc)
                ms[side].append(event_ms(call, ITERS))
                if name in DEVICE_TIMED:
                    match, per_call = DEVICE_TIMED[name]
                    device_ms[side].append(kernel_device_ms(call, match, ITERS, per_call))
            row = {"name": name, "shape": shape,
                   "same_bits": bool(torch.equal(outs["other"], outs["this"])),
                   "max_abs_diff": float((outs["other"].float()
                                          - outs["this"].float()).abs().max()),
                   "ms_this": ms["this"], "ms_other": ms["other"], "card": card}
            if name in DEVICE_TIMED:
                row.update(device_ms_this=device_ms["this"], device_ms_other=device_ms["other"])
            print(json.dumps(row), flush=True)
            rows.append(row)
            del outs
    finally:
        use(THIS)
    return rows


if __name__ == "__main__":
    main()
