"""Feature-artifact I/O contract, copied from ``mmer_tpu/core/artifacts.py``
(the port imports nothing from the JAX package; a test holds this copy to
the original).

Matches the reference's on-disk formats exactly so the frameworks are
drop-in interchangeable at the artifact level:

- video features: ``(T, 768)`` float32 ``.npy`` per clip
  (reference video_extractor.py:176, one row per 32-frame chunk)
- audio features: ``(1024,)`` float16 ``.npy`` per clip, L2-normalized
  (reference voice_extractor.py:95,118,142)
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

VIDEO_DIM = 768
AUDIO_DIM = 1024


class ArtifactError(ValueError):
    pass


def load_video_features(path: str) -> np.ndarray:
    arr = np.load(path)
    if arr.ndim != 2 or arr.shape[1] != VIDEO_DIM:
        raise ArtifactError(f"{path}: expected (T, {VIDEO_DIM}), got {arr.shape}")
    return arr.astype(np.float32)


def load_audio_features(path: str) -> np.ndarray:
    arr = np.load(path)
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 1 or arr.shape[0] != AUDIO_DIM:
        raise ArtifactError(f"{path}: expected ({AUDIO_DIM},), got {arr.shape}")
    return arr.astype(np.float32)


def save_video_features(path: str, feats: np.ndarray) -> None:
    feats = np.asarray(feats, dtype=np.float32)
    if feats.ndim != 2 or feats.shape[1] != VIDEO_DIM:
        raise ArtifactError(f"refusing to save video features of shape {feats.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, feats)


def save_audio_features(path: str, emb: np.ndarray) -> None:
    emb = np.asarray(emb)
    if emb.ndim != 1 or emb.shape[0] != AUDIO_DIM:
        raise ArtifactError(f"refusing to save audio features of shape {emb.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, emb.astype(np.float16))


def validate_pair(video: np.ndarray, audio: np.ndarray) -> Tuple[int, int]:
    """Return (T, audio_dim) after validating the artifact contract."""
    if video.ndim != 2 or video.shape[1] != VIDEO_DIM:
        raise ArtifactError(f"bad video features {video.shape}")
    if audio.ndim != 1 or audio.shape[0] != AUDIO_DIM:
        raise ArtifactError(f"bad audio features {audio.shape}")
    return video.shape[0], audio.shape[0]
