"""Mono waveforms at the configuration's sample rate, handed to
``embed_batch`` as a list of host float32 arrays (what a decoder yields).

Parameters (``workloads/<cell>.json``):

- ``clips_per_call``, ``calls``: the period is ``calls`` calls of
  ``clips_per_call`` distinct clips each;
- ``seconds``: ``[lo, hi]``; a call's clip lengths are the ``clips_per_call``
  midpoints of equal slices of ``[lo, hi]`` (uniform lengths, stratified), in
  the seed's order, so every call and every seed asks for the same audio
  seconds and pads to the same bucket;
- ``rate_per_s`` (optional): an open loop at that mean rate of calls
  (``benchmark.traffic.arrivals``); without it, a closed loop.

Each clip is speech-like in its spectrum: three tones, log-uniform over
80-4,000 Hz, amplitude-modulated at 1-8 Hz, over noise whose spectrum falls
as 1/f^a (a uniform over 0-1.5) at a random level, so that clips embed apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.traffic import Traffic, arrivals
from benchmark.weights import generator


def lengths(n: int, lo: float, hi: float, rate: int) -> np.ndarray:
    """The ``n`` stratified clip lengths in samples."""
    return np.round((lo + (hi - lo) * (np.arange(n) + 0.5) / n) * rate).astype(np.int64)


def clips(lens, rate: int, seed: int, device: torch.device) -> list:
    """Seeded waveforms of ``lens`` samples each → host float32 arrays."""
    gen = generator(seed, device, stream=2)
    n, top = len(lens), int(max(lens))

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((n, *shape), generator=gen, device=device)

    t = torch.arange(top, device=device, dtype=torch.float32)[None] / rate
    freq = torch.exp(u(math.log(80.0), math.log(4000.0), 3, 1))
    amp, phase = u(0.2, 1.0, 3, 1), u(0.0, 2 * math.pi, 3, 1)
    am_f, am_p = u(1.0, 8.0, 3, 1), u(0.0, 2 * math.pi, 3, 1)
    tones = (amp * (1 + 0.5 * torch.sin(2 * math.pi * am_f * t[:, None] + am_p))
             * torch.sin(2 * math.pi * freq * t[:, None] + phase)).sum(1)
    white = torch.randn((n, top), generator=gen, device=device)
    spec = torch.fft.rfft(white)
    f = torch.arange(spec.shape[1], device=device).clamp_min(1).float()
    spec = spec * f[None] ** (-0.5 * u(0.0, 1.5, 1))
    noise = torch.fft.irfft(spec, n=top)
    noise = noise / noise.std(dim=1, keepdim=True)
    wave = (tones + u(0.05, 0.5, 1) * noise).cpu().numpy()
    return [wave[i, :int(k)].copy() for i, k in enumerate(lens)]


def make(params: dict, m: dict, seed: int, device: torch.device) -> Traffic:
    n, k = params["clips_per_call"], params["calls"]
    rate = m["sample_rate"]
    base = lengths(n, *params["seconds"], rate)
    rng = np.random.default_rng(seed)
    lens = np.concatenate([base[rng.permutation(n)] for _ in range(k)])
    items = clips(lens, rate, seed, device)
    calls = []
    for c in range(k):
        ids = np.arange(c * n, (c + 1) * n)
        calls.append((ids, [items[i] for i in ids]))
    return Traffic(items, calls, *arrivals(params, len(calls), seed))
