"""Scaling evidence for the extraction fan-out and the data-parallel trainer,
the port of ``mmer_tpu/parallel/scaling.py``.

Every function here runs on each rank of a ``torch.distributed`` world of
``n`` ranks (``torchrun``, or :func:`main`'s spawned gloo ranks on the CPU):

- **correctness**: the mesh path's outputs against the single-device path's
  on the same inputs and weights (``max_abs_err``; the extractors within
  1e-5, the trainer's best score within 1e-3 relative);
- **strong efficiency**: the same global batch through one rank alone
  (``t_single``) and through the mesh (``t_sharded``, the slowest rank, its
  collectives included).  Each rank of the port is a worker of its own (a
  card, or a share of the host's cores), so the ideal sharded time is
  ``t_single / n`` and ``efficiency = t_single / (n * t_sharded)``: 1.0 is
  perfect scaling.  JAX's virtual CPU mesh shares one host's cores between
  its devices, so its ideal is ``t_single`` itself;
- **weak efficiency**: one rank's time at the per-device batch over the
  mesh's time at the global batch (``weak_efficiency_raw``; clamped at 1 in
  ``weak_efficiency``).

While rank 0 times a single-device leg the other ranks wait at a barrier.
The extractors run their plain path at the small f32 configs below, as the
JAX module does; the trainer runs the full-width fusion model.

    torchrun --nproc_per_node N -m mmer_tpu_torch.parallel.scaling --train
    python3 -m mmer_tpu_torch.parallel.scaling --device cpu --n_devices 4

One JSON line on stdout.  A failing leg exits non-zero (the JAX module keeps
the extract results when its train leg fails; this one does not).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# Small enough to run in seconds on a CPU rank (the JAX module's configs).
_VIVIT_KW = dict(image_size=(64, 64), patch_size=(16, 16), num_frames=8,
                 tubelet_size=4, dim=128, depth=4, heads=4, dim_head=32,
                 mlp_dim=256, compute_dtype="float32")
# A spawned CPU world's limit: the full-size train leg takes minutes there.
WORLD_S = 3600.0
_W2V2_KW = dict(hidden_dim=128, num_layers=2, num_heads=4, ffn_dim=256,
                conv_dims=(64,) * 7, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, compute_dtype="float32")


def _world(n_devices: int) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(f"need a world of {n_devices} ranks, found {world}")
    return world


def _time_best(fn: Callable, reps: int, device: torch.device) -> float:
    """Best of ``reps`` timed calls after one untimed warm-up, each ending
    in a device synchronise."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _rank0(fn: Callable, reps: int, device: torch.device) -> Optional[float]:
    """``_time_best`` on rank 0 alone, the others waiting."""
    t = _time_best(fn, reps, device) if not dist.is_initialized() \
        or dist.get_rank() == 0 else None
    if dist.is_initialized():
        dist.barrier()
    return t


def _slowest(t: float, device: torch.device) -> float:
    """The slowest rank's time."""
    if not dist.is_initialized():
        return t
    x = torch.tensor([t], dtype=torch.float64, device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return float(x[0])


def _legs(t_single: float, t_sharded: float, t_pd: float, n: int) -> dict:
    raw = t_pd / t_sharded
    return {"t_single_s": round(t_single, 4),
            "t_sharded_s": round(t_sharded, 4),
            "efficiency": round(t_single / (n * t_sharded), 4),
            "t_single_per_device_batch_s": round(t_pd, 4),
            "weak_efficiency": round(min(raw, 1.0), 4),
            "weak_efficiency_raw": round(raw, 4)}


def measure_extract_scaling(n_devices: int, reps: int = 3,
                            per_device_batch: int = 16,
                            device: torch.device | str = "cuda") -> dict:
    """Mesh against single device for both extractors → ``{"n_devices",
    "video": {...}, "audio": {...}}`` (rank 0's times, the same errors on
    every rank).  Raises if outputs disagree beyond 1e-5."""
    from mmer_tpu_torch.config import MeshConfig, ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.core.mesh import create_mesh
    from mmer_tpu_torch.models.wav2vec2 import (AudioEmbedder,
                                                feat_extract_output_length)
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor

    device = torch.device(device)
    n = _world(n_devices)
    mesh = create_mesh(MeshConfig())
    g = per_device_batch * n                 # global batch
    rng = np.random.default_rng(0)
    out = {"n_devices": n}

    # ---- ViViT chunk embedding ------------------------------------------
    vcfg = ViViTConfig(**_VIVIT_KW)
    single = VideoFeatureExtractor(vcfg, device=device, device_batch=g,
                                   use_kernels=False)
    sharded = VideoFeatureExtractor(vcfg, device=device, device_batch=g,
                                    use_kernels=False, mesh=mesh,
                                    params=single.model.state_dict())
    f, (h, w) = vcfg.num_frames, vcfg.image_size
    chunks = (rng.random((g, f, h, w, 3)) * 255).astype(np.uint8)
    want = single.embed_chunks(chunks)
    got = sharded.embed_chunks(chunks)
    v_err = float(np.max(np.abs(got - want)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    x = torch.from_numpy(chunks).to(device).float() / 255.0
    rows = mesh.batch_rows(g)

    with torch.inference_mode():
        t_single = _rank0(lambda: single.model(x), reps, device)
        t_pd = _rank0(lambda: single.model(x[:per_device_batch]), reps, device)
        t_sharded = _slowest(_time_best(
            lambda: mesh.all_gather_rows(sharded.model(x[rows])), reps, device),
            device)
    out["video"] = {"max_abs_err": v_err, "global_batch": g}
    if t_single is not None:
        out["video"].update(_legs(t_single, t_sharded, t_pd, n))

    # ---- Wav2Vec2 waveform embedding ------------------------------------
    acfg = Wav2Vec2Config(**_W2V2_KW)
    a_single = AudioEmbedder(acfg, device=device, use_kernels=False)
    a_sharded = AudioEmbedder(acfg, device=device, use_kernels=False,
                              mesh=mesh, params=a_single.model.state_dict())
    waves = [rng.normal(size=(16000 + 997 * i,)).astype(np.float32)
             for i in range(g)]
    a_want = a_single.embed_batch(waves)
    a_got = a_sharded.embed_batch(waves)
    a_err = float(np.max(np.abs(a_got - a_want)))
    np.testing.assert_allclose(a_got, a_want, atol=1e-5, rtol=1e-5)
    n_pad = a_single._bucket_len(2 * acfg.sample_rate)
    t_out = feat_extract_output_length(acfg, n_pad)
    batch = torch.from_numpy(
        rng.normal(size=(g, n_pad)).astype(np.float32)).to(device)
    mask = torch.zeros((g, t_out), dtype=torch.bool, device=device)
    ta_single = _rank0(lambda: a_single.embed_rows(batch, mask), reps, device)
    ta_pd = _rank0(lambda: a_single.embed_rows(batch[:per_device_batch],
                                               mask[:per_device_batch]),
                   reps, device)
    ta_sharded = _slowest(_time_best(
        lambda: mesh.all_gather_rows(a_sharded.embed_rows(batch[rows],
                                                          mask[rows])),
        reps, device), device)
    out["audio"] = {"max_abs_err": a_err, "global_batch": g}
    if ta_single is not None:
        out["audio"].update(_legs(ta_single, ta_sharded, ta_pd, n))
    return out


def measure_train_scaling(n_devices: int, reps: int = 2, epochs: int = 4,
                          batch: int = 1024, n_samples: int = 4096,
                          max_chunks: int = 5,
                          device: torch.device | str = "cuda") -> dict:
    """Data-parallel efficiency of ``train_model`` at the full-width fusion
    model: the same global batch (a convergence hyperparameter) split over
    the data axis against one rank alone, with the best score of the first
    timed run held within 1e-3 relative of the single-device run's."""
    from mmer_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
    from mmer_tpu_torch.data.pipeline import (DataSplits, DatasetArrays,
                                              balanced_class_weights,
                                              stratified_splits)
    from mmer_tpu_torch.train.loop import train_model

    device = torch.device(device)
    n = _world(n_devices)
    rng = np.random.default_rng(0)
    t = max_chunks
    labels = rng.integers(0, 6, size=(n_samples,)).astype(np.int32)
    lengths = rng.integers(1, t + 1, size=(n_samples,)).astype(np.int32)
    data = DatasetArrays(
        video=rng.normal(size=(n_samples, t, 768)).astype(np.float32),
        audio=rng.normal(size=(n_samples, 1024)).astype(np.float32),
        pad_mask=np.arange(t)[None, :] >= lengths[:, None],
        labels=labels, lengths=lengths,
        keys=[str(i) for i in range(n_samples)], max_chunks=t)
    tr, va, te = stratified_splits(labels, seed=42)
    splits = DataSplits(tr, va, te, balanced_class_weights(labels[tr]))
    model_cfg = ModelConfig(max_seq_len=t + 1)
    train_cfg = TrainConfig(lr=1e-4, num_epochs=epochs, patience=10 ** 9,
                            save_checkpoints=False)

    def timed(mesh_cfg):
        scores = []

        def once():
            out = train_model(data, splits, model_cfg, train_cfg,
                              batch_size=batch, seed=len(scores),
                              verbose=False, device=device, mesh_cfg=mesh_cfg)
            scores.append(out.best_score)

        return _time_best(once, reps, device), scores[1]   # [0] is the warm-up

    single = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        single = timed(None)
    if dist.is_initialized():
        dist.barrier()
    t_sharded, s_sharded = timed(MeshConfig())
    t_sharded = _slowest(t_sharded, device)
    out = {"n_devices": n, "epochs": epochs, "global_batch": batch,
           "n_samples": n_samples, "t_sharded_s": round(t_sharded, 4)}
    if single is None:
        return out
    t_single, s_single = single
    if not (abs(s_single - s_sharded)
            <= 1e-3 * max(abs(s_single), abs(s_sharded), 1e-9)):
        raise AssertionError(f"dp{n} run diverged from single-device: best "
                             f"score {s_sharded} vs {s_single}")
    raw = t_single / (n * t_sharded)
    out.update({"t_single_s": round(t_single, 4),
                "efficiency": round(min(raw, 1.0), 4),
                "efficiency_raw": round(raw, 4),
                "best_score_abs_diff": round(abs(s_single - s_sharded), 6)})
    return out


def run(n_devices: int, device: str, reps: int, per_device_batch: int,
        train: bool, train_only: bool, train_epochs: int) -> dict:
    """The measurements :func:`main` asks for, on this rank."""
    if train_only:
        return {"train": measure_train_scaling(n_devices, epochs=train_epochs,
                                               device=device)}
    result = measure_extract_scaling(n_devices, reps=reps,
                                     per_device_batch=per_device_batch,
                                     device=device)
    if train:
        result["train"] = measure_train_scaling(n_devices, epochs=train_epochs,
                                                device=device)
    return result


def main(argv=None) -> dict:
    from mmer_tpu_torch.core.mesh import init_from_env
    from mmer_tpu_torch.parallel.launch import spawn_cpu_world

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_devices", type=int, default=None,
                        help="ranks (default: torchrun's world; 2 on the CPU)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (under torchrun: one card a rank, NCCL) or "
                             "cpu (spawns --n_devices gloo ranks)")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--per_device_batch", type=int, default=16)
    parser.add_argument("--train", action="store_true",
                        help="also measure the trainer's dp efficiency")
    parser.add_argument("--train_only", action="store_true",
                        help="measure only the trainer's dp efficiency")
    parser.add_argument("--train_epochs", type=int, default=4)
    args = parser.parse_args(argv)
    legs = (args.reps, args.per_device_batch, args.train, args.train_only,
            args.train_epochs)
    if "WORLD_SIZE" in os.environ:
        device = str(init_from_env(args.device))
        n = args.n_devices or dist.get_world_size()
        result = run(n, device, *legs)
        dist.destroy_process_group()
        if int(os.environ.get("RANK", 0)) != 0:
            return result
    elif args.device == "cpu":
        n = args.n_devices or 2
        result = spawn_cpu_world(run, n, (n, "cpu", *legs), timeout_s=WORLD_S,
                                 pg_timeout_s=WORLD_S)[0]
    else:
        raise SystemExit("scaling: launch under torchrun for CUDA ranks, or "
                         "pass --device cpu --n_devices N")
    result["device"] = (torch.cuda.get_device_name(0)
                        if args.device != "cpu" else "cpu")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
