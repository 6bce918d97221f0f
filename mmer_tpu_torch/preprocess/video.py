"""Host video decode → fixed-shape chunk arrays for the ViViT extractor,
copied from ``mmer_tpu/preprocess/video.py`` (the port imports nothing from
the JAX package; a test holds this copy to the original).

Behavioral contract (reference video_extractor.py:106-143): decode all
frames, BGR→RGB, resize to 224², scale to [0, 1], split into 32-frame
chunks, pad the final partial chunk by repeating the last frame.

Fixed here (NOT replicated): the reference reshapes its (T, C, H, W) frame
stack with ``view(num_chunks, 3, chunk_size, H, W)`` (video_extractor.py:141),
which silently interleaves the channel and time axes — every chunk after
the first mixes channels from neighboring frames.  This loader produces
honestly-shaped (num_chunks, chunk_size, H, W, 3) arrays (channels-last, the
layout the ViViT's tubelet embedding takes).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

VIDEO_EXTENSIONS = {".mp4", ".mkv", ".avi", ".mov", ".wmv", ".flv",
                    ".webm", ".m4v", ".mpg", ".mpeg"}


def decode_frames(video_path: str, size: Tuple[int, int] = (224, 224),
                  to_rgb: bool = True, resize: bool = True) -> Optional[np.ndarray]:
    """Decode every frame → (T, H, W, 3) uint8, or None on failure."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return None
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if to_rgb:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if resize:
            frame = cv2.resize(frame, size)
        frames.append(frame)
    cap.release()
    if not frames:
        return None
    return np.stack(frames)


def iter_video_frames(video_path: str) -> Tuple[float, Iterator[np.ndarray]]:
    """(fps, iterator of (H, W, 3) uint8 RGB frames) of a container, decoded
    one frame at a time (``cv2.VideoCapture``; BGR → RGB), as the JAX
    engine's ``infer_video_file`` reads an upload.  The frame rate defaults
    to 30 when the container does not say; an undecodable file gives no
    frames.  The capture is released when the iterator ends or is closed."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = float(cap.get(cv2.CAP_PROP_FPS) or 30.0)

    def frames() -> Iterator[np.ndarray]:
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        finally:
            cap.release()

    return fps, frames()


def frames_to_chunks(frames: np.ndarray, chunk_size: int = 32,
                     dtype: str = "float32") -> np.ndarray:
    """(T, H, W, C) → (ceil(T/chunk), chunk, H, W, C), last chunk padded by
    repeating the final frame.  ``dtype='float32'`` scales to [0, 1];
    ``'uint8'`` keeps raw bytes (the extractor normalizes on device — 4×
    less host→device transfer)."""
    t = frames.shape[0]
    num_chunks = -(-t // chunk_size)
    pad = num_chunks * chunk_size - t
    if pad:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
    chunks = frames.reshape(num_chunks, chunk_size, *frames.shape[1:])
    if dtype == "uint8":
        return np.ascontiguousarray(chunks).astype(np.uint8)
    return chunks.astype(np.float32) / 255.0


def load_video_chunks(video_path: str, chunk_size: int = 32,
                      size: Tuple[int, int] = (224, 224),
                      dtype: str = "float32") -> Optional[np.ndarray]:
    frames = decode_frames(video_path, size)
    if frames is None:
        return None
    return frames_to_chunks(frames, chunk_size, dtype)


def video_fps(video_path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    cap.release()
    return float(fps)


def iter_video_files(folder: str) -> Iterator[str]:
    """Walk ``folder`` yielding video paths (reference extension set,
    video_extractor.py:161)."""
    for root, _, files in os.walk(folder):
        for name in sorted(files):
            if os.path.splitext(name)[1].lower() in VIDEO_EXTENSIONS:
                yield os.path.join(root, name)


def feature_output_name(video_path: str, folder: str) -> str:
    """The reference's artifact naming: relative path with separators and
    dots replaced by underscores + ``_features.npy``
    (video_extractor.py:173-174) — kept for drop-in artifact parity."""
    rel = os.path.relpath(video_path, folder)
    return rel.replace(os.sep, "_").replace(".", "_") + "_features.npy"
