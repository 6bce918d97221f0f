"""Disk-backed batch stream for feature sets larger than device memory, the
port of ``mmer_tpu/data/streaming.py``.

The training path keeps the whole feature dataset in device memory
(``data/pipeline.py``, right for this dataset's ~115 MB).  This is the
alternative for larger sets: shuffled, padded, fixed-shape batches read from
disk each epoch.

- Fixed shapes: every batch is exactly (batch_size, max_chunks, 768) /
  (batch_size, 1024), with a True-for-pad mask and a sample weight that is 0
  on the ragged tail's empty rows.
- The epoch's shuffle is JAX's: ``np.random.default_rng(SeedSequence([seed,
  epoch]))``, so the batches equal the JAX stream's exactly.
- Each batch is read by the native loader (``data/native_loader.py``); a
  file that breaks the contract is re-read by ``np.load``, which names it.
- Prefetch depth 2: a worker thread reads the next batches while the
  current one trains; on CUDA a batch is copied from pinned host memory with
  ``non_blocking=True``, so its transfer overlaps the step before it.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from mmer_tpu_torch.data.catalog import CatalogEntry


class StreamingFeatureDataset:
    """Disk-backed shuffled batch stream with device prefetch.
    ``native_batches`` counts the batches the native loader read."""

    def __init__(self, catalog: List[CatalogEntry], batch_size: int,
                 max_chunks: int, seed: int = 0,
                 norm_stats: Optional[dict] = None,
                 video_dim: int = 768, audio_dim: int = 1024):
        self.catalog = list(catalog)
        self.batch_size = batch_size
        self.max_chunks = max_chunks
        self.seed = seed
        self.norm_stats = norm_stats or {}
        self.video_dim = video_dim
        self.audio_dim = audio_dim
        self.native_batches = 0

    def __len__(self) -> int:
        return -(-len(self.catalog) // self.batch_size)

    # -- host side ---------------------------------------------------------
    def _load_batch(self, entries: List[CatalogEntry]) -> Dict[str, np.ndarray]:
        from mmer_tpu_torch.core.artifacts import (load_audio_features,
                                                   load_video_features)
        from mmer_tpu_torch.data import native_loader

        bs = self.batch_size
        video = np.zeros((bs, self.max_chunks, self.video_dim), np.float32)
        audio = np.zeros((bs, self.audio_dim), np.float32)
        pad_mask = np.ones((bs, self.max_chunks), bool)
        labels = np.zeros((bs,), np.int32)
        weight = np.zeros((bs,), np.float32)

        native = native_loader.load_feature_arrays_native(
            [e.video_path for e in entries], [e.audio_path for e in entries],
            max_rows=self.max_chunks)
        self.native_batches += native is not None
        for i, entry in enumerate(entries):
            if native is not None:
                v, a = native[0][i], native[1][i]
            else:
                v = load_video_features(entry.video_path)
                a = load_audio_features(entry.audio_path)
            t = min(v.shape[0], self.max_chunks)
            video[i, :t] = v[:t]
            audio[i] = a
            pad_mask[i, :t] = False
            labels[i] = entry.label
            weight[i] = 1.0

        vm, vs = self.norm_stats.get("video_mean"), self.norm_stats.get("video_std")
        if vm is not None:
            video[weight > 0, :] = (video[weight > 0] - vm) / vs
            am, as_ = self.norm_stats["audio_mean"], self.norm_stats["audio_std"]
            audio[weight > 0] = (audio[weight > 0] - am) / as_
        return {"video": video, "audio": audio, "pad_mask": pad_mask,
                "labels": labels, "weight": weight}

    # -- device side ---------------------------------------------------------
    def epoch(self, epoch_idx: int, device: Optional[torch.device | str] = None,
              prefetch: int = 2) -> Iterator[Dict]:
        """Yield one shuffled epoch's batches: numpy arrays when ``device`` is
        None (JAX's ``device_put=False``), else tensors on ``device``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch_idx]))
        order = rng.permutation(len(self.catalog))
        batches = [order[s:s + self.batch_size]
                   for s in range(0, len(order), self.batch_size)]
        device = None if device is None else torch.device(device)

        def produce(idx_block):
            batch = self._load_batch([self.catalog[i] for i in idx_block])
            if device is None:
                return batch
            if device.type != "cuda":
                return {k: torch.from_numpy(a).to(device) for k, a in batch.items()}
            return {k: torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                    for k, a in batch.items()}

        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = [pool.submit(produce, b) for b in batches[:prefetch]]
            next_submit = prefetch
            for _ in range(len(batches)):
                batch = pending.pop(0).result()
                if next_submit < len(batches):
                    pending.append(pool.submit(produce, batches[next_submit]))
                    next_submit += 1
                yield batch
