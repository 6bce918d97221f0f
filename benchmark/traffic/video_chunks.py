"""Raw uint8 video chunks, (F, H, W, C) as the configuration's ViViT takes
them, handed to ``embed_chunks`` as host arrays (what a decoder yields).

Parameters (``workloads/<cell>.json``):

- ``sizes``: chunks a call, one entry a call of the period; the period's
  calls take consecutive runs of a pool of ``sum(sizes)`` distinct chunks,
  in the seed's order, and each call's argument is a view of the pool (no
  copy inside the window);
- ``rate_per_s`` (optional): an open loop at that mean rate of calls
  (``benchmark.traffic.arrivals``); without it, a closed loop.

Each chunk is interpolated from a coarse (time, height, width) field of
:data:`GRID`, so that tubelets differ within a chunk, as frames of a clip
do.  On it lies the chunk's own texture: one random pattern the size of a
tubelet, of amplitude :data:`TEXTURE`, repeated over the chunk, as a scene
keeps its texture under changing light.  It sets the chunks' features apart
(the CLS token of the seeded ViViT sees mostly the mean over its tokens,
which a smooth field alone leaves alike from chunk to chunk), by far more
than the program's rounding.  Fine noise of :data:`NOISE` pixel levels lies
on top.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.traffic import Traffic, arrivals, periods
from benchmark.weights import generator

BLOCK = 16          # chunks drawn on the device at once
GRID = (9, 8, 8)    # the coarse field's (time, height, width)
TEXTURE = 0.3       # the texture's amplitude, in [0, 1] pixels
NOISE = 8.0         # the fine noise's amplitude in pixel levels


def chunks(n: int, m: dict, seed: int, device: torch.device) -> np.ndarray:
    """``n`` seeded uint8 chunks (n, F, H, W, C) on the host."""
    gen = generator(seed, device, stream=1)
    f, (h, w), c = m["num_frames"], m["image_size"], m["in_channels"]
    t, (ph, pw) = m["tubelet_size"], m["patch_size"]
    out = np.empty((n, f, h, w, c), np.uint8)
    for s in range(0, n, BLOCK):
        b = min(BLOCK, n - s)
        coarse = torch.rand((b, c, *GRID), generator=gen, device=device)
        # Each chunk its own level and contrast in each channel.
        level = torch.rand((b, c, 1, 1, 1), generator=gen, device=device)
        contrast = torch.rand((b, c, 1, 1, 1), generator=gen, device=device)
        coarse = 0.15 + 0.7 * level + (0.3 + 0.7 * contrast) * (coarse - 0.5)
        video = F.interpolate(coarse, size=(f, h, w), mode="trilinear",
                              align_corners=True)
        tile = torch.rand((b, c, t, ph, pw), generator=gen, device=device)
        video = video + TEXTURE * (2 * tile - 1).repeat(1, 1, f // t, h // ph, w // pw)
        fine = torch.rand(video.shape, generator=gen, device=device)
        video = video + (fine - 0.5) * (2 * NOISE / 255.0)
        video = (video.clamp(0, 1) * 255).round().to(torch.uint8)
        out[s:s + b] = video.permute(0, 2, 3, 4, 1).cpu().numpy()
    return out


def make(params: dict, m: dict, seed: int, device: torch.device) -> Traffic:
    calls = periods(params["sizes"], seed)
    pool = chunks(sum(params["sizes"]), m, seed, device)
    return Traffic(pool, [(ids, pool[ids[0]:ids[-1] + 1]) for ids in calls],
                   *arrivals(params, len(calls), seed))
