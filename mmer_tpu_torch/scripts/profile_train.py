"""Where does a training step's time go?  A torch.profiler pass over the
fusion trainer's epoch function at ``ModelConfig()`` width.

    python3 -m mmer_tpu_torch.scripts.profile_train [--device cuda]

A seeded dataset of the real size (8,496 samples of up to 5 video chunks,
6,796 of them in the training split) is made in memory and put on the device;
one epoch warms up, a second is timed on the host clock, and ``--steps`` steps
run twice under the profiler, the second pass recorded.  Printed: ms per step, samples/s, the
device's busy time per step and its idle share (against the unprofiled step
time), the number of device kernels per step, and the kernels that take the most device time.
``--device cpu --tiny`` rehearses the control flow (no device numbers).

``--seeds S`` profiles S seeds in one batched program instead
(``train/fused.train_many_seeds``, dropout 0.2 as the flagship recipe):
one warm-up call, then one call of an epoch over the whole training split
timed (its ``wall_seconds``, set-up excluded) and one under the profiler; the
device time and operations of a call that runs no epoch (the set-up: S
seeded models, the dataset's upload) are taken off before they are divided
by the steps.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mmer_tpu_torch.config import ModelConfig, TrainConfig
from mmer_tpu_torch.models.fusion import init_fusion
from mmer_tpu_torch.ops import prng
from mmer_tpu_torch.scripts.timing import (device_events, device_work,
                                           resolve_device)
from mmer_tpu_torch.train.keys import KeySchedule
from mmer_tpu_torch.train.loop import make_optimizer, train_epoch

N_SAMPLES, N_TRAIN, MAX_CHUNKS = 8496, 6796, 5


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="a small dataset and model (the CPU rehearsal)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=20,
                   help="steps under the profiler")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", type=int, default=0,
                   help="S > 0: S seeds in one batched program "
                        "(train_many_seeds) in place of the one trainer's "
                        "epoch")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    n, n_train = (200, 160) if args.tiny else (N_SAMPLES, N_TRAIN)
    cfg = ModelConfig(fused_dim=32, fusion_ffn_dim=64, fusion_heads=2,
                      classifier_hidden_dim=32) if args.tiny else ModelConfig()
    tcfg = TrainConfig()
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(1, MAX_CHUNKS + 1, size=n)

    host = {
        "video": rng.normal(size=(n, MAX_CHUNKS, cfg.video_dim)).astype(np.float32),
        "audio": rng.normal(size=(n, cfg.audio_dim)).astype(np.float32),
        "pad_mask": np.arange(MAX_CHUNKS)[None, :] >= lengths[:, None],
        "labels": rng.integers(0, cfg.num_classes, size=n),
    }
    if args.seeds:
        return _profile_batched(args, device, cfg, host, lengths, n_train)
    data = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    class_weights = torch.ones(cfg.num_classes, device=device)
    model = init_fusion(cfg, device=device, seed=args.seed)
    optimizer = make_optimizer(model, tcfg)
    keys = KeySchedule([args.seed], "loop", cfg, tcfg, args.batch_size,
                       MAX_CHUNKS, device)

    def epoch(idx):
        loss = train_epoch(model, optimizer, data, idx, class_weights, tcfg,
                           args.batch_size, keys=keys)
        return float(loss)          # the epoch's one host sync

    train_idx = torch.arange(n_train, device=device)
    steps_per_epoch = -(-n_train // args.batch_size)
    epoch(train_idx)
    t0 = time.perf_counter()
    epoch(train_idx)
    epoch_s = time.perf_counter() - t0
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "steps_per_epoch": steps_per_epoch, "epoch_s": epoch_s,
           "step_ms": epoch_s * 1e3 / steps_per_epoch,
           "samples_per_s": n_train / epoch_s}
    print(f"device={out['device']} batch {args.batch_size}: epoch of "
          f"{steps_per_epoch} steps {epoch_s:.3f} s, {out['step_ms']:.3f} ms a "
          f"step, {out['samples_per_s']:.1f} samples/s", flush=True)
    if device.type != "cuda":
        return out

    from torch.profiler import ProfilerActivity, profile, schedule

    window = train_idx[:args.steps * args.batch_size]
    torch.cuda.synchronize(device)
    # A warm-up pass under the profiler, dropped (timing.device_work), then
    # the recorded one.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        epoch(window)
        torch.cuda.synchronize(device)
        prof.step()
        draws0 = prng.launch_threefry.launches
        t0 = time.perf_counter()
        epoch(window)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        # One launch draws a step's masks; one more the epoch's shuffle.
        threefry = prng.launch_threefry.launches - draws0
    # Device-side kernels and copies only (timing.device_events), by launch;
    # summed by name for the table below.
    events = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    launches = len(events)
    by_name: dict = {}
    for e in events:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    # The profiler slows the host several times over, so the idle share is
    # taken against the unprofiled step time, not against the window.
    busy_step_ms = busy_ms / args.steps
    out.update(profiled_steps=args.steps, window_ms=wall_ms,
               device_busy_ms_per_step=busy_step_ms,
               idle_share=1.0 - busy_step_ms / out["step_ms"],
               device_ops_per_step=launches / args.steps,
               threefry_launches=threefry)
    print(f"profiled {args.steps} steps ({wall_ms:.2f} ms with the profiler on): "
          f"device busy {busy_step_ms:.3f} ms of the {out['step_ms']:.3f} ms "
          f"step, idle share {out['idle_share']:.3f}, "
          f"{out['device_ops_per_step']:.0f} device operations a step, "
          f"{threefry} threefry launches ({args.steps} steps and the shuffle)")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ms:8.3f} ms  {n:6d} x  {name[:90]}")
    return out


def _profile_batched(args, device, cfg: ModelConfig, host: dict,
                     lengths: np.ndarray, n_train: int) -> dict:
    """``--seeds S``: one batched epoch's time, device busy time and
    operations a step (see the module docstring)."""
    import dataclasses

    from mmer_tpu_torch.data.pipeline import DataSplits, DatasetArrays
    from mmer_tpu_torch.train.fused import train_many_seeds

    n = len(host["labels"])
    data = DatasetArrays(video=host["video"], audio=host["audio"],
                         pad_mask=host["pad_mask"],
                         labels=host["labels"].astype(np.int32),
                         lengths=lengths.astype(np.int32),
                         keys=[str(i) for i in range(n)], max_chunks=MAX_CHUNKS)
    held_out = np.arange(n_train, n)
    splits = DataSplits(np.arange(n_train), held_out[:64], held_out[64:128],
                        np.ones(cfg.num_classes, np.float32))
    cfg = dataclasses.replace(cfg, fusion_dropout=0.2, classifier_dropout=0.2)
    seeds = list(range(args.seed, args.seed + args.seeds))

    def call(epochs):
        return train_many_seeds(data, splits, cfg, TrainConfig(num_epochs=epochs),
                                args.batch_size, seeds, len(seeds),
                                verbose=False, device=device)

    call(1)
    epoch_s = call(1)[0]["wall_seconds"]
    steps = -(-n_train // args.batch_size)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "seeds": len(seeds), "steps_per_epoch": steps, "epoch_s": epoch_s,
           "step_ms": epoch_s * 1e3 / steps,
           "samples_per_s_per_seed": n_train / epoch_s}
    print(f"device={out['device']} {len(seeds)} seeds at batch "
          f"{args.batch_size}: epoch of {steps} steps {epoch_s:.3f} s, "
          f"{out['step_ms']:.3f} ms a step, "
          f"{out['samples_per_s_per_seed']:.1f} samples/s a seed", flush=True)
    if device.type != "cuda":
        return out
    busy, ops = device_work(lambda: call(1), device)
    busy0, ops0 = device_work(lambda: call(0), device)
    out.update(device_busy_ms_per_step=(busy - busy0) / steps,
               device_ops_per_step=(ops - ops0) / steps)
    out["idle_share"] = 1.0 - out["device_busy_ms_per_step"] / out["step_ms"]
    print(f"device busy {out['device_busy_ms_per_step']:.3f} ms of the "
          f"{out['step_ms']:.3f} ms step, idle share {out['idle_share']:.3f}, "
          f"{out['device_ops_per_step']:.0f} device operations a step "
          f"(set-up: {busy0:.2f} ms, {ops0} operations, taken off)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
