"""Double-buffered against serial block loop in ``VideoFeatureExtractor``,
the port of ``scripts/probe_extract_pipeline.py``.

    python3 -m mmer_tpu_torch.scripts.probe_extract_pipeline [--device cuda]

``embed_chunks(pipeline=True)`` stages block i+1 on the host and enqueues
its copy and forward before block i's result is fetched;
``pipeline=False`` runs the blocks one after another.  The same
host-resident uint8 workload (6 blocks x 16 seeded 32x224x224x3 chunks, 96
chunks, 462 MB) goes through both shapes of the loop on the default kernel
route, best of 2 wall-clock calls each after a warm-up block; it prints
chunks/s, the speedup and the overlap reclaimed, and fails unless the two
outputs are bit-identical (``embed_chunks`` promises that).
``--device cpu --tiny`` rehearses the control flow on a small config.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from mmer_tpu_torch.config import ViViTConfig
from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
from mmer_tpu_torch.scripts.profile_vivit import TINY
from mmer_tpu_torch.scripts.timing import resolve_device

B = 16
N_BLOCKS = 6
REPS = 2            # calls of each loop shape; the best is kept


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a small config (the CPU rehearsal)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ViViTConfig(**TINY) if args.tiny else ViViTConfig()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    ex = VideoFeatureExtractor(cfg, device=device, device_batch=B)

    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, size=(N_BLOCKS * B, cfg.num_frames,
                                       *cfg.image_size, 3), dtype=np.uint8)
    print(f"device={device} workload: {N_BLOCKS} blocks x B={B} "
          f"({clips.shape[0]} chunks, {clips.nbytes / 1e6:.0f} MB uint8)",
          flush=True)
    ex.embed_chunks(clips[:B])

    outs = {}

    def timed(pipeline: bool) -> float:
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = ex.embed_chunks(clips, pipeline=pipeline)
            best = min(best, time.perf_counter() - t0)
            if out.shape != (clips.shape[0], cfg.dim):
                raise RuntimeError(f"embed_chunks returned {out.shape}")
            outs.setdefault(pipeline, out)
        return best

    t_serial = timed(pipeline=False)
    t_pipe = timed(pipeline=True)
    n = clips.shape[0]
    same = bool(np.array_equal(outs[False], outs[True]))
    print(f"serial   : {t_serial:7.3f} s  {n / t_serial:6.1f} chunks/s", flush=True)
    print(f"pipelined: {t_pipe:7.3f} s  {n / t_pipe:6.1f} chunks/s  "
          f"speedup {t_serial / t_pipe:4.2f}x", flush=True)
    overlap = t_serial - t_pipe
    print(f"overlap reclaimed: {overlap:.3f} s "
          f"({overlap / t_serial * 100:.0f}% of serial); outputs "
          f"{'bit-identical' if same else 'DIFFER'}", flush=True)
    if not same:
        raise RuntimeError("pipeline=True gave other bits than pipeline=False")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return [{"name": f"pipeline={pipeline}", "ms": t * 1e3,
             "chunks_per_s": n / t, "calls": REPS, "blocks": N_BLOCKS,
             "device": name, "clock": "host"}
            for pipeline, t in ((False, t_serial), (True, t_pipe))] + [
        {"name": "pipeline speedup", "speedup": t_serial / t_pipe,
         "overlap_s": overlap, "bit_identical": same, "device": name}]


if __name__ == "__main__":
    main(sys.argv[1:])
