"""Host data pipeline: load features → normalize → split → dense padded arrays
(copied from ``mmer_tpu/data/pipeline.py``; numpy only).

The whole dataset (~115 MB) is materialized as fixed-shape dense arrays and
kept resident in device memory for the entire training run.  Batching is an
on-device gather of a permuted index array: there is no per-step
host→device transfer, unlike the reference's DataLoader loop
(train2.py:564-568).

Semantics preserved from the reference:
- global per-dim z-score over the whole dataset, std with Bessel correction
  (+1e-6), applied per sample (train2.py:362-378);
- zero padding of variable-length video sequences with a True-for-padded mask
  (collate_fn, train2.py:418-443);
- stratified 80/10/10 split with seed 42, sample for sample the one sklearn's
  two-stage ``train_test_split`` draws (train2.py:400-413);
- balanced class weights with a 1.2x boost for FEA/DIS (train2.py:475-486);
- v1 options: per-sample normalization (train.py:176-177) and NEU
  oversampling (train.py:199-211).

:func:`stratified_splits` is not a copy: it draws sklearn's split in numpy
(the port does not depend on sklearn).
"""

from __future__ import annotations

import concurrent.futures as cf
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from mmer_tpu_torch.config import DataConfig, NUM_CLASSES
from mmer_tpu_torch.core.artifacts import load_audio_features, load_video_features
from mmer_tpu_torch.data.catalog import CatalogEntry, build_catalog


@dataclass
class DatasetArrays:
    """Fixed-shape dataset ready for device residency."""

    video: np.ndarray      # (N, T_max, 768) float32, zero-padded
    audio: np.ndarray      # (N, 1024) float32
    pad_mask: np.ndarray   # (N, T_max) bool, True = padded position
    labels: np.ndarray     # (N,) int32
    lengths: np.ndarray    # (N,) int32
    keys: List[str]
    max_chunks: int
    video_mean: Optional[np.ndarray] = None
    video_std: Optional[np.ndarray] = None
    audio_mean: Optional[np.ndarray] = None
    audio_std: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        return self.video.shape[0]


@dataclass
class DataSplits:
    train: np.ndarray
    val: np.ndarray
    test: np.ndarray
    class_weights: np.ndarray  # (num_classes,) float32


def _load_entry(entry: CatalogEntry) -> Tuple[np.ndarray, np.ndarray]:
    return load_video_features(entry.video_path), load_audio_features(entry.audio_path)


def load_feature_arrays(catalog: List[CatalogEntry], num_workers: int = 16,
                        use_native: bool = True
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Bulk host load of all feature files.

    Native route (default): the C++ thread-pool loader
    (``data/native_loader.py``), one call for all video artifacts and one
    for all audio; it raises if the library cannot be built.  An artifact
    that breaks the contract sends the load through the numpy route
    (``use_native=False``: threaded ``np.load``), which raises a per-file
    :class:`ArtifactError`."""
    if use_native:
        from mmer_tpu_torch.data import native_loader

        result = native_loader.load_feature_arrays_native(
            [e.video_path for e in catalog], [e.audio_path for e in catalog],
            n_threads=num_workers)
        if result is not None:
            return result
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        results = list(pool.map(_load_entry, catalog))
    videos = [v for v, _ in results]
    audios = np.stack([a for _, a in results]).astype(np.float32)
    return videos, audios


def normalize_global(videos: List[np.ndarray], audios: np.ndarray
                     ) -> Tuple[List[np.ndarray], np.ndarray, dict]:
    """Global per-dim z-score (v2 semantics, train2.py:362-378).

    torch ``Tensor.std`` uses Bessel's correction (ddof=1) — matched here.
    """
    all_video = np.concatenate(videos, axis=0)
    v_mean = all_video.mean(axis=0)
    v_std = all_video.std(axis=0, ddof=1) + 1e-6
    a_mean = audios.mean(axis=0)
    a_std = audios.std(axis=0, ddof=1) + 1e-6
    videos = [(v - v_mean) / v_std for v in videos]
    audios = (audios - a_mean) / a_std
    stats = dict(video_mean=v_mean, video_std=v_std,
                 audio_mean=a_mean, audio_std=a_std)
    return videos, audios.astype(np.float32), stats


def normalize_per_sample(videos: List[np.ndarray], audios: np.ndarray
                         ) -> Tuple[List[np.ndarray], np.ndarray, dict]:
    """Per-sample z-score (v1 semantics, train.py:176-177; numpy ddof=0)."""
    videos = [(v - v.mean(axis=0)) / (v.std(axis=0) + 1e-6) for v in videos]
    a_mean = audios.mean(axis=1, keepdims=True)
    a_std = audios.std(axis=1, keepdims=True) + 1e-6
    audios = (audios - a_mean) / a_std
    return videos, audios.astype(np.float32), {}


def pad_videos(videos: List[np.ndarray], max_chunks: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad to (N, T_max, D) and build the True-for-padded mask
    (reference collate_fn, train2.py:418-443)."""
    lengths = np.asarray([v.shape[0] for v in videos], dtype=np.int32)
    t_max = int(max_chunks or lengths.max())
    # Clamp so lengths always describe the PADDED array (a caller-capped
    # t_max truncates clips; reporting the pre-truncation length would
    # desync every consumer of lengths/max_chunks from the data width).
    lengths = np.minimum(lengths, t_max)
    n, d = len(videos), videos[0].shape[1]
    out = np.zeros((n, t_max, d), dtype=np.float32)
    for i, v in enumerate(videos):
        t = min(v.shape[0], t_max)
        out[i, :t] = v[:t]
    pad_mask = np.arange(t_max)[None, :] >= lengths[:, None]
    return out, pad_mask, lengths


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_approximate_mode``: the most likely per-class counts of
    ``n_draws`` draws from ``class_counts``; ties among the largest
    remainders are broken with ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(y: np.ndarray, test_size: float, seed: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Positions (train, test) of one draw of sklearn's
    ``StratifiedShuffleSplit(test_size=test_size, random_state=seed)``, which
    is what ``train_test_split(..., stratify=y)`` returns: the same calls on
    the same ``RandomState`` in the same order (train then test counts from
    :func:`_approximate_mode`, one permutation per class in class order, a
    permutation of each side)."""
    n_samples = len(y)
    n_test = int(np.ceil(test_size * n_samples))
    n_train = n_samples - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if class_counts.min() < 2:
        raise ValueError("stratified split: the least populated class has "
                         "fewer than 2 members")
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(f"stratified split: train size {n_train} and test "
                         f"size {n_test} must each reach the number of "
                         f"classes {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_splits(labels: np.ndarray, seed: int = 42
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """80/10/10 stratified split, index for index the reference's two-stage
    sklearn ``train_test_split`` (train2.py:400-413), so sample membership
    matches run for run."""
    labels = np.asarray(labels)
    train_idx, temp_idx = _stratified_shuffle_split(labels, 0.2, seed)
    val_pos, test_pos = _stratified_shuffle_split(labels[temp_idx], 0.5, seed)
    return (np.asarray(train_idx, dtype=np.int32),
            np.asarray(temp_idx[val_pos], dtype=np.int32),
            np.asarray(temp_idx[test_pos], dtype=np.int32))


def balanced_class_weights(train_labels: np.ndarray,
                           boost_classes=(4, 5), boost_factor: float = 1.2
                           ) -> np.ndarray:
    """sklearn 'balanced' weights with the reference's FEA/DIS boost
    (train2.py:475-486)."""
    n = len(train_labels)
    counts = np.bincount(train_labels, minlength=NUM_CLASSES).astype(np.float64)
    classes_present = counts > 0
    w = np.zeros(NUM_CLASSES, dtype=np.float64)
    w[classes_present] = n / (classes_present.sum() * counts[classes_present])
    for c in boost_classes:
        w[c] *= boost_factor
    return w.astype(np.float32)


def oversample_neutral(train_idx: np.ndarray, labels: np.ndarray,
                       target_count: Optional[int] = None,
                       seed: int = 0) -> np.ndarray:
    """v1 trainer's NEU oversampling to the majority count
    (train.py:199-211 — the reference hardcodes ``majority_count = 1170
    "From your counter"``, its dataset's literal majority count).
    ``target_count=None`` derives the majority count from the data, so
    any other dataset oversamples to ITS majority instead of inheriting
    CREMA-D+RAVDESS's magic number (which would explode a small
    dataset's NEU class); pass 1170 explicitly for the bit-level v1
    replica."""
    if target_count is None:
        counts = np.bincount(labels[train_idx])
        target_count = int(counts.max()) if len(counts) else 0
    minority = train_idx[labels[train_idx] == 0]
    if len(minority) == 0 or len(minority) >= target_count:
        return train_idx
    factor = target_count // len(minority)
    extra = np.concatenate([minority] * (factor - 1)) if factor > 1 else minority[:0]
    remaining = target_count - len(minority) * factor
    rng = np.random.default_rng(seed)
    extra = np.concatenate(
        [extra, rng.choice(minority, remaining, replace=False)])
    out = np.concatenate([train_idx, extra]).astype(np.int32)
    rng.shuffle(out)
    return out


def dataset_from_features(videos: List[np.ndarray], audios: np.ndarray,
                          labels: np.ndarray, keys: List[str],
                          cfg: DataConfig,
                          max_chunks: Optional[int] = None
                          ) -> Tuple[DatasetArrays, DataSplits]:
    """Shared pipeline tail: normalize → pad → split → weights.

    Used by :func:`load_dataset` (features from ``.npy`` artifacts) and by
    callers that hold freshly embedded features in memory."""
    if cfg.normalization == "global":
        videos, audios, stats = normalize_global(videos, audios)
    elif cfg.normalization == "per_sample":
        videos, audios, stats = normalize_per_sample(videos, audios)
    else:
        raise ValueError(f"unknown normalization: {cfg.normalization}")

    video, pad_mask, lengths = pad_videos(videos, max_chunks)
    labels = np.asarray(labels, dtype=np.int32)

    data = DatasetArrays(
        video=video, audio=audios, pad_mask=pad_mask, labels=labels,
        lengths=lengths, keys=list(keys),
        # The PADDED width, not lengths.max(): with a caller-passed
        # max_chunks the two differ, and downstream max_seq_len =
        # max_chunks + 1 must match the actual (N, T, D) data width.
        max_chunks=int(video.shape[1]),
        video_mean=stats.get("video_mean"), video_std=stats.get("video_std"),
        audio_mean=stats.get("audio_mean"), audio_std=stats.get("audio_std"),
    )

    train_idx, val_idx, test_idx = stratified_splits(labels, seed=cfg.seed)
    if cfg.oversample_neutral:
        train_idx = oversample_neutral(train_idx, labels, seed=cfg.seed)
    weights = balanced_class_weights(
        labels[train_idx], cfg.boost_classes, cfg.boost_factor)
    splits = DataSplits(train=train_idx, val=val_idx, test=test_idx,
                        class_weights=weights)
    return data, splits


def load_dataset(cfg: DataConfig, max_chunks: Optional[int] = None,
                 num_workers: int = 16) -> Tuple[DatasetArrays, DataSplits]:
    """Full host pipeline: catalog → load → normalize → pad → split → weights."""
    catalog = build_catalog(cfg.video_feat_dir, cfg.audio_feat_dir, cfg.pairing)
    videos, audios = load_feature_arrays(catalog, num_workers=num_workers)
    labels = np.asarray([e.label for e in catalog], dtype=np.int32)
    return dataset_from_features(videos, audios, labels,
                                 [e.key for e in catalog], cfg, max_chunks)
