"""Where does a warm serving request's time go?  A torch.profiler pass over
``InferenceEngine`` at the full default widths, seeded weights.

    python3 -m mmer_tpu_torch.scripts.profile_serve [--device cuda]

Three requests made from a seed (``predict_chunks`` on 3 chunks + 3.2 s of
audio and on 1 chunk + 12 s, ``infer_sequence`` on 5 subchunks at 30 fps) are
served once to warm up, ``--repeats`` times on the host clock, and once each
under the profiler.  Printed per request: its wall time, the device's busy
time and idle share (against the unprofiled wall time: the profiler slows the
host), the number of device operations, and the operations that take the most
device time.  ``--device cpu --tiny`` rehearses the control flow at small
configs (no device numbers).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig, ViViTConfig, Wav2Vec2Config
from mmer_tpu_torch.scripts.timing import resolve_device
from mmer_tpu_torch.serve.engine import InferenceEngine

TINY = dict(
    model_cfg=dict(video_dim=64, audio_dim=32, fused_dim=32, max_seq_len=8,
                   fusion_layers=2, fusion_heads=2, fusion_ffn_dim=64,
                   classifier_hidden_dim=32, compute_dtype="float32"),
    vivit_cfg=dict(image_size=(32, 32), patch_size=(16, 16), num_frames=8,
                   tubelet_size=4, dim=64, depth=2, heads=2, dim_head=32,
                   mlp_dim=128, compute_dtype="float32"),
    wav_cfg=dict(hidden_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
                 conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                 compute_dtype="float32"))


def make_requests(rng, vcfg: ViViTConfig):
    """(name, entry point, arguments) of the three requests."""
    def clip(n):
        return rng.integers(0, 256, dtype=np.uint8, size=(
            n, vcfg.num_frames, *vcfg.image_size, vcfg.in_channels))

    def audio(seconds):
        return (rng.normal(size=(int(seconds * 16000),)) * 0.1).astype(np.float32)

    frames = list(range(5 * vcfg.num_frames))
    return [("predict_chunks 3 chunks + 3.2 s audio", "predict_chunks",
             (clip(3), audio(3.2))),
            ("predict_chunks 1 chunk + 12 s audio", "predict_chunks",
             (clip(1), audio(12.0))),
            ("infer_sequence 5 subchunks @ 30 fps", "infer_sequence",
             (clip(5), frames, audio(len(frames) / 30.0 + 0.7), 30.0))]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="small configs (the CPU rehearsal)")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed passes over the requests before the profile")
    p.add_argument("--top", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfgs = {}
    if args.tiny:
        cfgs = dict(model_cfg=ModelConfig(**TINY["model_cfg"]),
                    vivit_cfg=ViViTConfig(**TINY["vivit_cfg"]),
                    wav_cfg=Wav2Vec2Config(**TINY["wav_cfg"]))
    engine = InferenceEngine(device, **cfgs)
    requests = make_requests(np.random.default_rng(args.seed), engine.vivit_cfg)
    on_card = device.type == "cuda"

    def serve(entry, req_args):
        res = getattr(engine, entry)(*req_args)
        if on_card:
            torch.cuda.synchronize(device)
        return res

    for _, entry, req_args in requests:            # warm-up
        serve(entry, req_args)
    rows = []
    for name, entry, req_args in requests:
        walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            serve(entry, req_args)
            walls.append((time.perf_counter() - t0) * 1e3)
        row = {"name": name, "wall_ms": min(walls), "wall_ms_all": walls,
               "device": torch.cuda.get_device_name(device) if on_card else "cpu"}
        print(f"device={row['device']} {name}: wall "
              + ", ".join(f"{w:.2f}" for w in walls) + " ms", flush=True)
        rows.append(row)
    if not on_card:
        return rows

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for row, (name, entry, req_args) in zip(rows, requests):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve(entry, req_args)
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
        row.update(device_busy_ms=busy_ms, device_ops=sum(e.count for e in ops),
                   idle_share=1.0 - busy_ms / row["wall_ms"])
        print(f"{name}: device busy {busy_ms:.3f} ms of the {row['wall_ms']:.2f} ms "
              f"request, idle share {row['idle_share']:.3f}, "
              f"{row['device_ops']} device operations")
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:args.top]:
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d} x  "
                  f"{e.key[:100]}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
