"""Multi-device dry run, the port of ``__graft_entry__.py:dryrun_multichip``.

``n`` ranks run, over a (data, model) mesh with tp = 2 when ``n`` is even:
one dp×tp training step of the full-width fusion model
(``ModelConfig(max_seq_len=6)``), a 2-epoch ``train_model`` over the same
mesh, and the extraction fan-out
(``parallel/scaling.py:measure_extract_scaling``).  Rank 0's lines are
printed.  On the cards, one NCCL rank a card under ``torchrun``; on the
CPU, ``--device cpu`` spawns ``--n_devices`` gloo ranks
(:mod:`~mmer_tpu_torch.parallel.launch`):

    python3 -m torch.distributed.run --nproc_per_node 4 \
        -m mmer_tpu_torch.parallel.dryrun
    python3 -m mmer_tpu_torch.parallel.dryrun --device cpu --n_devices 4
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch


def _dryrun_body(n_devices: int, device: torch.device | str) -> List[str]:
    """One rank's part of the dry run on ``device`` (this rank's card, or
    the CPU); rank 0's report lines."""
    from mmer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
    from mmer_tpu_torch.core.mesh import create_mesh
    from mmer_tpu_torch.data.pipeline import (DataSplits, DatasetArrays,
                                              balanced_class_weights,
                                              stratified_splits)
    from mmer_tpu_torch.models.fusion import init_fusion
    from mmer_tpu_torch.parallel.scaling import measure_extract_scaling
    from mmer_tpu_torch.parallel.sharding import shard_params
    from mmer_tpu_torch.train.keys import KeySchedule
    from mmer_tpu_torch.train.loop import (StepDraws, make_optimizer,
                                           train_model, train_step)

    device = torch.device(device)
    mp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = create_mesh(MeshConfig(model_parallel=mp))
    if mesh.size != n_devices:
        raise RuntimeError(f"dry run needs {n_devices} ranks, found {mesh.size}")
    lines = []

    model_cfg = ModelConfig(max_seq_len=6)
    train_cfg = TrainConfig()
    batch = 2 * n_devices
    rng = np.random.default_rng(0)
    data = {"video": torch.from_numpy(rng.normal(size=(batch, 5, 768)).astype(np.float32)),
            "audio": torch.from_numpy(rng.normal(size=(batch, 1024)).astype(np.float32)),
            "pad_mask": torch.zeros((batch, 5), dtype=torch.bool),
            "labels": torch.from_numpy(rng.integers(0, 6, size=(batch,)))}
    data = {k: v.to(device) for k, v in data.items()}
    model = shard_params(init_fusion(model_cfg, device=device, seed=0), mesh)
    optimizer = make_optimizer(model, train_cfg)
    model.train()
    keys = KeySchedule([0], "loop", model_cfg, train_cfg, batch, 5, device)
    loss = train_step(model, optimizer, data,
                      torch.arange(batch, device=device), StepDraws(),
                      torch.ones(6, device=device), train_cfg, keys.draw(),
                      mesh=mesh)
    loss = float(mesh.all_reduce(loss.clone()))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    lines.append(f"dryrun_multichip OK: mesh={mesh.shape} loss={loss:.4f}")

    # JAX's 8 a device, at least 64: the stratified split's held-out halves
    # need two samples of each class.
    n = max(8 * n_devices, 64)
    labels = np.asarray(np.arange(n) % 6, np.int32)       # balanced classes
    lengths = np.asarray(rng.integers(1, 6, size=(n,)), np.int32)
    tiny = DatasetArrays(
        video=rng.normal(size=(n, 5, 768)).astype(np.float32),
        audio=rng.normal(size=(n, 1024)).astype(np.float32),
        pad_mask=np.arange(5)[None, :] >= lengths[:, None],
        labels=labels, lengths=lengths,
        keys=[str(i) for i in range(n)], max_chunks=5)
    tr, va, te = stratified_splits(labels, seed=42)
    splits = DataSplits(tr, va, te, balanced_class_weights(labels[tr]))
    out = train_model(tiny, splits, model_cfg,
                      TrainConfig(num_epochs=2, lr=1e-3, save_checkpoints=False,
                                  patience=10 ** 9),
                      batch_size=2 * n_devices, verbose=False, device=device,
                      mesh_cfg=MeshConfig(model_parallel=mp))
    if len(out.results) != 2 or not np.isfinite(out.results[-1]["train_loss"]):
        raise AssertionError(f"the 2-epoch run failed: {out.results}")
    lines.append(f"dryrun train_model OK: 2 epochs over dp{n_devices // mp}xtp{mp}, "
                 f"final train loss {out.results[-1]['train_loss']:.4f}")

    sc = measure_extract_scaling(n_devices, reps=1, per_device_batch=2,
                                 device=device)
    if "t_single_s" in sc["video"]:
        lines.append(f"dryrun extract fan-out OK: dp{n_devices} "
                     f"video err {sc['video']['max_abs_err']:.2e} "
                     f"eff {sc['video']['efficiency']:.2f}, "
                     f"audio err {sc['audio']['max_abs_err']:.2e} "
                     f"eff {sc['audio']['efficiency']:.2f}")
    return lines


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> List[str]:
    """Run the dry run on ``n_devices`` spawned gloo ranks on the CPU; print
    and return rank 0's lines.  Raises if a rank fails or the world
    outlives ``timeout_s``."""
    from mmer_tpu_torch.parallel.launch import spawn_cpu_world

    lines = spawn_cpu_world(_dryrun_body, n_devices, (n_devices, "cpu"),
                            timeout_s=timeout_s)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> List[str]:
    import torch.distributed as dist

    from mmer_tpu_torch.core.mesh import init_from_env

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_devices", type=int, default=8,
                        help="gloo ranks to spawn with --device cpu")
    parser.add_argument("--device", default="cuda",
                        help="cuda (under torchrun: one card a rank, NCCL) or "
                             "cpu (spawns --n_devices gloo ranks)")
    args = parser.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        device = init_from_env(args.device)
        rank = dist.get_rank()
        try:
            lines = _dryrun_body(dist.get_world_size(), device)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            for line in lines:
                print(line, flush=True)
        return lines
    if args.device != "cpu":
        raise SystemExit("dryrun: pass --device cpu (gloo ranks) or launch "
                         "under torchrun for CUDA ranks")
    return dryrun_multichip(args.n_devices)


if __name__ == "__main__":
    main()
