"""The card's published peaks and the CUDA-event timer, shared by the
profile and probe scripts and by ``chip_smoke.py``."""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

# Published dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet).
PEAK_FLOPS = 989e12
# Its HBM3 memory rate, bytes per second (same data sheet).
PEAK_BYTES = 3.35e12
# Timed passes over the pre-staged inputs (after one warm-up pass).
ROUNDS = 3


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass --device cpu for a rehearsal")
    return device


def event_ms(fn: Callable, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()`` on the current CUDA device: ``warmup``
    calls, then CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_ms(fn: Callable, inputs: Sequence[tuple], device: torch.device,
             rounds: int = ROUNDS) -> float:
    """Milliseconds per call of ``fn(*args)``, cycling over the distinct
    pre-staged ``inputs`` (together larger than the L2 cache, so every call
    finds its operands cold).  On a card: one warm-up call per input, then
    CUDA events around ``rounds`` passes over the inputs.  On the CPU the
    host clock (a rehearsal of the control flow, not a device time)."""
    def one_pass():
        for args in inputs:
            fn(*args)

    one_pass()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(rounds):
            one_pass()
        return (time.perf_counter() - t0) * 1e3 / (rounds * len(inputs))
    with torch.cuda.device(device):
        return event_ms(one_pass, rounds, warmup=0) / len(inputs)


def rate_row(name: str, ms: float, flops: float, device: torch.device,
             **extra) -> dict:
    """One result row: ms per call, TFLOP/s and the share of the bf16 peak."""
    rate = flops / (ms * 1e-3)
    row = {"name": name, "ms": ms, "tflops": rate / 1e12,
           "peak_share": rate / PEAK_FLOPS, "device": (
               torch.cuda.get_device_name(device) if device.type == "cuda"
               else "cpu"), **extra}
    print(f"{name:24s} {ms:9.4f} ms  {row['tflops']:7.2f} TFLOP/s  "
          f"{100 * row['peak_share']:5.2f} % of {PEAK_FLOPS / 1e12:.0f} TFLOP/s"
          + "".join(f"  {k}={v:.3e}" for k, v in extra.items()
                    if isinstance(v, float)), flush=True)
    return row
