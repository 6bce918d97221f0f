"""The card's published peaks and the CUDA-event timer, shared by the
profile and probe scripts and by ``chip_smoke.py``."""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

# Published dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet).
PEAK_FLOPS = 989e12
# Its dense int8 tensor-core peak, operations per second (same data sheet).
PEAK_INT8_OPS = 1979e12
# Its HBM3 memory rate, bytes per second (same data sheet).
PEAK_BYTES = 3.35e12
# Timed passes over the pre-staged inputs (after one warm-up pass).
ROUNDS = 3
# Distinct pre-staged inputs a leg of the component probes cycles over (one
# in a ``--tiny`` rehearsal).
INPUTS = 3


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


# Traced windows kernel_device_ms tries before it gives up.  On an H100 a
# window now and then showed fewer kernels than were launched (19 of 21, 9 of
# 10); the next window of the same calls showed them all.
TRACE_ATTEMPTS = 3


def kernel_device_ms(fn: Callable, match: str, iters: int, per_call: int) -> list:
    """Device time of each of the ``per_call`` kernel launches of one
    ``fn()`` call whose name holds ``match``, in launch order, in
    milliseconds averaged over ``iters`` calls after a warm-up one.  Read from
    a torch.profiler trace of the card, so the host's time between two
    launches is not counted.  A window that does not show exactly ``per_call
    * iters`` such kernels is traced again, up to TRACE_ATTEMPTS windows.
    With one launch a call, a window that dropped some (an H100 run showed
    19, 14 and 19 of 20 in three windows) still times the launches it shows:
    after TRACE_ATTEMPTS such windows, the mean over the fullest one, if it
    shows at least half of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen, fullest = [], []
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA and match in e.name),
                         key=lambda e: e.time_range.start)
        if len(kernels) == per_call * iters:
            return [sum(e.time_range.elapsed_us() for e in kernels[i::per_call]) / iters / 1e3
                    for i in range(per_call)]
        seen.append(len(kernels))
        if len(fullest) < len(kernels) < iters:
            fullest = kernels
    if per_call == 1 and 2 * len(fullest) >= iters:
        return [sum(e.time_range.elapsed_us() for e in fullest) / len(fullest) / 1e3]
    raise RuntimeError(f"the profiler saw {seen} kernels named *{match}* in "
                       f"{TRACE_ATTEMPTS} windows of {iters} calls, not "
                       f"{per_call * iters}")


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple:
    """(the least ms the card could take for ``flops`` operations and
    ``nbytes`` bytes, at ``peak`` operations a second (the bf16 peak unless
    given) and the memory rate; "operations" or "bytes", whichever bounds
    it)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_randn(shape, dtype: torch.dtype, device: torch.device, seed: int,
                 n: int) -> list:
    """``n`` unit-normal tensors of ``shape``, drawn on ``device`` from seeds
    ``seed``, ``seed + 1``, ..."""
    gen = torch.Generator(device=device)
    out = []
    for i in range(n):
        gen.manual_seed(seed + i)
        out.append(torch.randn(shape, generator=gen, device=device, dtype=dtype))
    return out


def timed_row(name: str, fn: Callable, inputs: Sequence[tuple], flops: float,
              device: torch.device, **extra) -> dict:
    """:func:`rate_row` of :func:`timed_ms` over ``inputs``, with ``calls``:
    the calls of ``fn`` it made (a warm-up pass and ``ROUNDS`` timed ones)."""
    ms = timed_ms(fn, inputs, device)
    return {**rate_row(name, ms, flops, device, **extra),
            "calls": (1 + ROUNDS) * len(inputs)}


def device_events(prof) -> list:
    """A torch.profiler trace's device-side kernels and copies, each launch
    once: ``prof.events()``, which holds the kernels a ctypes call launches
    (``key_averages`` can leave out a kernel that no PyTorch operator
    launched), less user annotations' device-side spans and the optimizer's,
    which repeat the time of the kernels under them."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer.")]


def device_work(fn: Callable, device: torch.device) -> tuple:
    """(device busy ms, device operations) of one call of ``fn``, from a
    torch.profiler trace of the card (:func:`device_events`).  ``fn`` runs
    twice: a warm-up step, traced and dropped (on an H100 the first kernels
    after a trace starts were now and then missing from it), then the
    recorded one."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize(device)
    # One step() between the passes: a step past the active one would end
    # the cycle and clear its events.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize(device)
        prof.step()
        fn()
        torch.cuda.synchronize(device)
    events = device_events(prof)
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events))


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
