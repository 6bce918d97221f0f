"""Face detection and serving-side sequence grouping, the port of the
serving subset of ``mmer_tpu/preprocess/faces.py``.

:class:`HaarFaceDetector` runs the port's cascade (``preprocess/cascade.py``)
over the packaged cascade file, with no ``cv2``: the grayscale conversion is
:func:`_rgb_to_gray`, bit-equal to ``cv2.cvtColor(..., COLOR_RGB2GRAY)``.
Confidence is a monotone function of a detection's neighbour count (Haar has
no calibrated score).  :func:`group_face_sequences` groups detected frames
into gap-tolerant sequences (reference ``get_face_sequences``,
back-end/app/libs/inference.py:52-100).

The offline bbox tooling of the JAX module (``detect_near``, ``track_near``,
``extract_video_bboxes``, the ``.txt`` writers, ``write_face_video``,
``YoloFaceDetector``) is not ported yet (ROADMAP A2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

BBox = Tuple[int, float, float, float, float, float]  # frame,x1,y1,x2,y2,conf

# cv2's fixed-point RGB→gray for uint8: ITU-R BT.601 weights scaled by 2^15,
# rounded half up (equal to cv2.cvtColor on all 2^24 RGB values, OpenCV 5.0).
_GRAY_SHIFT = 15
_GRAY_RGB = np.array([9798, 19235, 3735], np.int64)


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB → (H, W) uint8 gray, bit-equal to
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)``."""
    acc = rgb.astype(np.int64) @ _GRAY_RGB + (1 << (_GRAY_SHIFT - 1))
    return (acc >> _GRAY_SHIFT).astype(np.uint8)


class HaarFaceDetector:
    """Haar-cascade face detector over the packaged cascade; ``.engine``
    says whether the native evaluator or the numpy fallback runs."""

    def __init__(self, scale_factor: float = 1.1, min_neighbors: int = 3,
                 cascade_path: Optional[str] = None, min_size: int = 48,
                 min_texture_std: float = 16.0):
        # scale_factor 1.1: coarser pyramids can step over a face's scale.
        # min_texture_std: drop boxes whose central-60 % grayscale std is
        # below this (the cascade's flat-blob false positives); 0 disables.
        from mmer_tpu_torch.preprocess.cascade import (HaarCascade,
                                                       find_cascade_file)

        path = cascade_path or find_cascade_file()
        if path is None:
            raise RuntimeError("the packaged haarcascade file is missing")
        self._cascade = HaarCascade(path)
        self.scale_factor = scale_factor
        self.min_neighbors = min_neighbors
        self.min_size = min_size
        self.min_texture_std = min_texture_std

    @property
    def engine(self) -> str:
        return self._cascade.engine

    def _texture_ok(self, gray: np.ndarray,
                    box: Tuple[float, float, float, float]) -> bool:
        if self.min_texture_std <= 0:
            return True
        x1, y1, x2, y2 = box
        bw, bh = x2 - x1, y2 - y1
        roi = gray[int(y1 + 0.2 * bh):int(y2 - 0.2 * bh),
                   int(x1 + 0.2 * bw):int(x2 - 0.2 * bw)]
        return roi.size > 0 and float(roi.std()) >= self.min_texture_std

    def detect(self, frame_rgb: np.ndarray
               ) -> List[Tuple[float, float, float, float, float]]:
        """→ [(x1, y1, x2, y2, conf)], highest confidence first."""
        gray = _rgb_to_gray(frame_rgb)
        dets = self._cascade.detect(
            gray, scale_factor=self.scale_factor,
            min_neighbors=self.min_neighbors, min_size=self.min_size)
        return [d for d in dets if self._texture_ok(gray, d[:4])]


def default_detector() -> HaarFaceDetector:
    return HaarFaceDetector()


def best_bbox_per_frame(rows: Sequence[BBox]) -> dict:
    """frame → highest-confidence (x1, y1, x2, y2)."""
    best: dict = {}
    for frame, x1, y1, x2, y2, conf in rows:
        if frame not in best or conf > best[frame][4]:
            best[frame] = (x1, y1, x2, y2, conf)
    return {f: v[:4] for f, v in best.items()}


@dataclass
class FaceSequence:
    frames: List[int]          # frame indices with detections
    bboxes: List[Tuple[float, float, float, float]]


def group_face_sequences(detections: Sequence[BBox], max_delay: int = 10,
                         max_frames_per_sequence: int = 10000
                         ) -> List[FaceSequence]:
    """Group detected-face frames into sequences, tolerating gaps up to
    ``max_delay`` frames (reference get_face_sequences,
    back-end/app/libs/inference.py:52-100)."""
    per_frame = best_bbox_per_frame(detections)
    seqs: List[FaceSequence] = []
    cur: Optional[FaceSequence] = None
    for frame in sorted(per_frame):
        if (cur is None or frame - cur.frames[-1] > max_delay
                or len(cur.frames) >= max_frames_per_sequence):
            cur = FaceSequence(frames=[], bboxes=[])
            seqs.append(cur)
        cur.frames.append(frame)
        cur.bboxes.append(per_frame[frame])
    return seqs
