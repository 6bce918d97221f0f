"""Face detection, the temporal face tracker, bbox artifacts and the
face-crop writer: the port of ``mmer_tpu/preprocess/faces.py``.

:class:`HaarFaceDetector` runs the port's cascade (``preprocess/cascade.py``)
over the packaged cascade file, with no ``cv2``: the grayscale conversion is
:func:`_rgb_to_gray`, bit-equal to ``cv2.cvtColor(..., COLOR_RGB2GRAY)``, and
the tracker's rotations and template matches are ``preprocess/imgproc.py``'s.
Confidence is a monotone function of a detection's neighbour count (Haar has
no calibrated score).

Offline tools (the reference's prep scripts, ``preprocess/prep.py``):

- :func:`extract_frame_bboxes`: per-frame detection with track-birth
  hysteresis, relaxed re-detection (:meth:`HaarFaceDetector.detect_near`,
  with rotated retries), NCC tracking (:meth:`HaarFaceDetector.track_near`)
  and gap interpolation, on decoded RGB frames;
  :func:`extract_video_bboxes` is its shell over a container
  (``preprocess/video.py:iter_video_frames``, which needs ``cv2``).
- ``frame,x1,y1,x2,y2,conf`` files (:func:`write_bboxes_txt`,
  :func:`read_bboxes_txt`, :func:`process_folder_bboxes`).
- :func:`crop_face_frames` / :func:`iter_face_crops`: every frame cropped to
  its best box (else the last box, else the whole frame) and resized on the
  device, in batches of 64; :func:`write_face_video` and
  :func:`convert_folder_faces` are their ``cv2`` shells.

:func:`group_face_sequences` groups detected frames into gap-tolerant
sequences for serving (reference ``get_face_sequences``,
back-end/app/libs/inference.py:52-100).  The JAX module's
``YoloFaceDetector`` is not ported: it needs ultralytics and a weights
download.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmer_tpu_torch.preprocess.imgproc import (TemplateMatcher, invert_affine,
                                               rotation_matrix_2d, warp_affine)

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

    def detect_near(self, frame_rgb: np.ndarray,
                    prior: Tuple[float, float, float, float],
                    expand: float = 0.75, iou_gate: float = 0.25,
                    retry_angles: Tuple[float, ...] = (15.0, -15.0,
                                                       30.0, -30.0)
                    ) -> Optional[Tuple[float, float, float, float, float]]:
        """Relaxed re-detection around a tracking prior: the cascade with
        ``min_neighbors=1`` and a min size scaled to the prior, only in the
        ``expand``-grown region around the last confirmed box, a candidate
        kept only if it overlaps the prior at IoU >= ``iou_gate``.  When the
        upright pass misses, the region is retried at the in-plane
        ``retry_angles`` and a hit is mapped back through the inverse
        rotation (the axis-aligned hull of its corners).  Without a prior
        there is no relaxed pass, so the no-face behaviour is the
        full-strength detector's."""
        ex1, ey1, ex2, ey2 = _grown_region(prior, expand, frame_rgb.shape)
        bw, bh = prior[2] - prior[0], prior[3] - prior[1]
        if ex2 - ex1 < 24 or ey2 - ey1 < 24:
            return None
        gray = _rgb_to_gray(frame_rgb[ey1:ey2, ex1:ex2])
        min_size = max(24, int(0.6 * min(bw, bh)))

        def roi_pass(img, inv: Optional[np.ndarray]):
            dets = self._cascade.detect(
                img, scale_factor=self.scale_factor, min_neighbors=1,
                min_size=min_size)
            best, best_iou = None, iou_gate
            for (dx1, dy1, dx2, dy2, conf) in dets:
                if not self._texture_ok(img, (dx1, dy1, dx2, dy2)):
                    continue
                if inv is not None:
                    corners = np.asarray(
                        [[dx1, dy1, 1], [dx2, dy1, 1],
                         [dx2, dy2, 1], [dx1, dy2, 1]], np.float64)
                    back = corners @ inv.T
                    dx1, dy1 = back[:, 0].min(), back[:, 1].min()
                    dx2, dy2 = back[:, 0].max(), back[:, 1].max()
                cand = (dx1 + ex1, dy1 + ey1, dx2 + ex1, dy2 + ey1)
                v = _iou(cand, prior)
                if v >= best_iou:
                    best, best_iou = (*cand, conf), v
            return best

        best = roi_pass(gray, None)
        if best is not None:
            return best
        rh, rw = gray.shape
        for angle in retry_angles:
            m = rotation_matrix_2d((rw / 2, rh / 2), angle, 1.0)
            best = roi_pass(warp_affine(gray, m, (rw, rh)), invert_affine(m))
            if best is not None:
                return best
        return None

    def track_near(self, frame_rgb: np.ndarray,
                   prior: Tuple[float, float, float, float],
                   template_gray: np.ndarray,
                   expand: float = 0.75, min_score: float = 0.45,
                   iou_gate: float = 0.25
                   ) -> Optional[Tuple[float, float, float, float, float]]:
        """NCC template fallback for frames that both cascade passes miss
        (chiefly partial occlusion): the last full-strength face patch
        ``template_gray`` and its four halves are matched (TM_CCOEFF_NORMED)
        inside the ``expand``-grown prior region, and the best-correlating
        part wins; the box keeps the template's extent at the matched
        place.  Gates: the score must clear ``min_score``, the box must
        overlap the prior at IoU >= ``iou_gate``, and there is no pass
        without a confirmed prior."""
        ex1, ey1, ex2, ey2 = _grown_region(prior, expand, frame_rgb.shape)
        th, tw = template_gray.shape[:2]
        if ex2 - ex1 < tw + 2 or ey2 - ey1 < th + 2 or th < 16 or tw < 16:
            return None
        matcher = TemplateMatcher(_rgb_to_gray(frame_rgb[ey1:ey2, ex1:ex2]))
        # (subpatch, box-anchor offset of the subpatch inside the template)
        parts = ((template_gray, 0, 0),
                 (template_gray[:th // 2], 0, 0),                  # top half
                 (template_gray[th - th // 2:], 0, th - th // 2),  # bottom
                 (template_gray[:, :tw // 2], 0, 0),               # left
                 (template_gray[:, tw - tw // 2:], tw - tw // 2, 0))  # right
        best = None
        for part, offx, offy in parts:
            score, (mx, my) = matcher.best(part)
            if score < min_score or (best and score <= best[0]):
                continue
            cx1 = float(ex1 + mx - offx)
            cy1 = float(ey1 + my - offy)
            cand = (cx1, cy1, cx1 + tw, cy1 + th)
            if _iou(cand, prior) < iou_gate:
                continue
            best = (float(score), cand)
        if best is None:
            return None
        return (*best[1], best[0])


def default_detector() -> HaarFaceDetector:
    return HaarFaceDetector()


def _grown_region(prior: Sequence[float], expand: float, shape
                  ) -> Tuple[int, int, int, int]:
    """The prior box grown by ``expand`` of its size on every side and
    clipped to a frame of ``shape``: integer (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = prior
    bw, bh = x2 - x1, y2 - y1
    fh, fw = shape[:2]
    return (max(int(x1 - expand * bw), 0), max(int(y1 - expand * bh), 0),
            min(int(x2 + expand * bw), fw), min(int(y2 + expand * bh), fh))


# ---------------------------------------------------------------------------
# the temporal tracker and the bbox artifact contract
# ---------------------------------------------------------------------------

def _face_patch(rgb: np.ndarray, box: Sequence[float]
                ) -> Optional[np.ndarray]:
    """Gray crop of a detection box (the NCC tracking template), or None
    when the in-frame part is too small to correlate meaningfully."""
    h, w = rgb.shape[:2]
    x1, y1 = max(int(box[0]), 0), max(int(box[1]), 0)
    x2, y2 = min(int(box[2]), w), min(int(box[3]), h)
    if x2 - x1 < 16 or y2 - y1 < 16:
        return None
    return _rgb_to_gray(rgb[y1:y2, x1:x2])


def _iou(a: Sequence[float], b: Sequence[float]) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(union, 1e-9)


@dataclass
class TrackStats:
    """What :func:`extract_frame_bboxes` wrote, by source: full-strength
    detections, relaxed re-detections, NCC-tracked frames, interpolated
    frames; and the frames it read."""
    frames: int = 0
    full: int = 0
    relaxed: int = 0
    tracked: int = 0
    interpolated: int = 0


def extract_frame_bboxes(frames_rgb: Iterable[np.ndarray], detector=None,
                         conf_threshold: float = 0.5,
                         temporal: bool = True,
                         max_gap: int = 10,
                         max_relaxed_chain: int = 15,
                         birth_window: int = 10,
                         birth_iou: float = 0.3,
                         stats: Optional[TrackStats] = None) -> List[BBox]:
    """Per-frame detection over (H, W, 3) uint8 RGB frames → [(frame, x1,
    y1, x2, y2, conf)]: every full-strength detection at or above
    ``conf_threshold`` (the reference keeps them all,
    cremad_extract_bboxes.py:39-47), plus, with ``temporal``, two recovery
    stages for the frames the full-strength pass misses:

    1. re-detection near the last confirmed box
       (:meth:`HaarFaceDetector.detect_near`), else an NCC match of the
       last full-strength face patch (:meth:`HaarFaceDetector.track_near`),
       at most ``max_relaxed_chain`` in a row before a full-strength
       detection is needed again;
    2. linear interpolation over gaps of at most ``max_gap`` frames between
       two anchored boxes, at the flanking boxes' lower confidence.

    Both stages engage only once a track is born: two full-strength
    detections within ``birth_window`` frames whose boxes overlap at IoU >=
    ``birth_iou``.  A track lapses after ``max_gap`` frames without a box.
    ``stats``, if given, counts the rows by source."""
    detector = detector or default_detector()
    stats = stats if stats is not None else TrackStats()
    rows: List[BBox] = []
    anchor_frames: List[int] = []      # confirmed-track frames with a box
    prior: Optional[Tuple[float, float, float, float]] = None
    prior_frame = -1
    relaxed_chain = 0
    confirmed = False
    template: Optional[np.ndarray] = None   # last full-strength face patch
    last_full: Optional[Tuple[float, float, float, float]] = None
    last_full_frame = -1
    frame_idx = 0
    for rgb in frames_rgb:
        dets = [d for d in detector.detect(rgb) if d[4] >= conf_threshold]
        if confirmed and prior is not None \
                and frame_idx - prior_frame > max_gap:
            confirmed = False          # track lapsed; a new pair must birth
        if dets:
            rows.extend((frame_idx, *d) for d in dets)
            stats.full += len(dets)
            best = max(dets, key=lambda d: d[4])
            if not confirmed and last_full is not None \
                    and frame_idx - last_full_frame <= birth_window \
                    and _iou(best[:4], last_full) >= birth_iou:
                confirmed = True
                anchor_frames.append(last_full_frame)  # retroactive anchor
            last_full, last_full_frame = best[:4], frame_idx
            if confirmed:
                prior, prior_frame, relaxed_chain = best[:4], frame_idx, 0
                anchor_frames.append(frame_idx)
                p = _face_patch(rgb, best[:4])
                template = p if p is not None else template
        elif (temporal and confirmed and prior is not None
                and frame_idx - prior_frame <= max_gap
                and relaxed_chain < max_relaxed_chain
                and hasattr(detector, "detect_near")):
            d = detector.detect_near(rgb, prior)
            if d is not None:
                stats.relaxed += 1
            elif template is not None and hasattr(detector, "track_near"):
                d = detector.track_near(rgb, prior, template)
                stats.tracked += d is not None
            if d is not None:
                rows.append((frame_idx, *d))
                prior, prior_frame = d[:4], frame_idx
                relaxed_chain += 1
                anchor_frames.append(frame_idx)
        frame_idx += 1
    stats.frames = frame_idx

    if temporal and anchor_frames:
        filled = _interpolate_gaps(rows, anchor_frames, max_gap)
        stats.interpolated += len(filled)
        rows.extend(filled)
        rows.sort(key=lambda r: r[0])
    return rows


def extract_video_bboxes(video_path: str, detector=None,
                         conf_threshold: float = 0.5, temporal: bool = True,
                         max_gap: int = 10, max_relaxed_chain: int = 15,
                         birth_window: int = 10, birth_iou: float = 0.3,
                         stats: Optional[TrackStats] = None) -> List[BBox]:
    """:func:`extract_frame_bboxes` over a container's decoded frames
    (``cv2``): the rows the JAX function returns."""
    from mmer_tpu_torch.preprocess.video import iter_video_frames

    _, frames = iter_video_frames(video_path)
    return extract_frame_bboxes(frames, detector, conf_threshold, temporal,
                                max_gap, max_relaxed_chain, birth_window,
                                birth_iou, stats)


def _interpolate_gaps(rows: Sequence[BBox], anchor_frames: Sequence[int],
                      max_gap: int) -> List[BBox]:
    """Linear bbox interpolation across <= ``max_gap``-frame holes between
    anchored detections; conf = the flanking boxes' min."""
    best = {}
    for frame, x1, y1, x2, y2, conf in rows:
        if frame not in best or conf > best[frame][4]:
            best[frame] = (x1, y1, x2, y2, conf)
    out: List[BBox] = []
    for lo, hi in zip(anchor_frames, anchor_frames[1:]):
        if hi - lo <= 1 or hi - lo > max_gap:
            continue
        a, b = np.asarray(best[lo]), np.asarray(best[hi])
        for f in range(lo + 1, hi):
            t = (f - lo) / (hi - lo)
            x1, y1, x2, y2 = (1 - t) * a[:4] + t * b[:4]
            out.append((f, float(x1), float(y1), float(x2), float(y2),
                        float(min(a[4], b[4]))))
    return out


def write_bboxes_txt(path: str, rows: Sequence[BBox]) -> None:
    """``frame,x1,y1,x2,y2,conf`` lines (cremad_extract_bboxes.py:48-56)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for frame, x1, y1, x2, y2, conf in rows:
            f.write(f"{frame},{x1:.1f},{y1:.1f},{x2:.1f},{y2:.1f},{conf:.4f}\n")


def read_bboxes_txt(path: str) -> List[BBox]:
    rows: List[BBox] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != 6:
                continue
            rows.append((int(float(parts[0])), *[float(p) for p in parts[1:]]))
    return rows


def process_folder_bboxes(input_dir: str, output_dir: str, detector=None,
                          conf_threshold: float = 0.5,
                          verbose: bool = True) -> int:
    """Walk ``input_dir`` (flat or actor subdirs) and write one
    ``<name>_bboxes.txt`` per video; returns the count."""
    from mmer_tpu_torch.preprocess.video import iter_video_files

    detector = detector or default_detector()
    count = 0
    for video_path in iter_video_files(input_dir):
        rows = extract_video_bboxes(video_path, detector, conf_threshold)
        stem = os.path.splitext(os.path.basename(video_path))[0]
        out = os.path.join(output_dir, f"{stem}_bboxes.txt")
        write_bboxes_txt(out, rows)
        count += 1
        if verbose:
            print(f"[{count}] {out} ({len(rows)} boxes)", flush=True)
    return count


# ---------------------------------------------------------------------------
# the face-crop writer (crop + resize on the device)
# ---------------------------------------------------------------------------

def best_bbox_per_frame(rows: Sequence[BBox]) -> dict:
    """frame → highest-confidence (x1, y1, x2, y2)."""
    best: dict = {}
    for frame, x1, y1, x2, y2, conf in rows:
        if frame not in best or conf > best[frame][4]:
            best[frame] = (x1, y1, x2, y2, conf)
    return {f: v[:4] for f, v in best.items()}


def _crop_device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("face crops: CUDA device requested but "
                           "torch.cuda.is_available() is False (pass "
                           "device='cpu' to run on the CPU)")
    return device


def iter_face_crops(frames: Iterable[np.ndarray], rows: Sequence[BBox],
                    size: Tuple[int, int] = (224, 224), batch: int = 64,
                    device: torch.device | str = "cuda"
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(boxes (n, 4) float32, crops (n, size[0], size[1], C)
    uint8)`` for ``batch`` frames at a time: each (H, W, C) uint8 frame
    cropped to its best box in ``rows``, else the last frame's box, else the
    whole frame (the JAX writer's rule), and bilinearly resized on
    ``device`` (``ops/image.py:crop_resize_batch``), the values clamped to
    [0, 255] and truncated to uint8 as the JAX writer's ``astype``."""
    from mmer_tpu_torch.ops.image import crop_resize_batch

    device = _crop_device(device)
    per_frame = best_bbox_per_frame(rows)
    block: List[np.ndarray] = []
    boxes: List[Tuple[float, float, float, float]] = []
    last_box: Optional[Tuple[float, float, float, float]] = None

    def flush():
        x = torch.from_numpy(np.stack(block)).to(device)
        b = np.asarray(boxes, np.float32)
        crops = crop_resize_batch(x, torch.from_numpy(b).to(device),
                                  out_hw=tuple(size))
        out = torch.clamp(crops, 0, 255).to(torch.uint8).cpu().numpy()
        block.clear()
        boxes.clear()
        return b, out

    for frame_idx, frame in enumerate(frames):
        h, w = frame.shape[:2]
        box = per_frame.get(frame_idx, last_box) or (0.0, 0.0, float(w),
                                                     float(h))
        last_box = box
        block.append(frame)
        boxes.append(box)
        if len(block) >= batch:
            yield flush()
    if block:
        yield flush()


def crop_face_frames(frames: Iterable[np.ndarray], rows: Sequence[BBox],
                     size: Tuple[int, int] = (224, 224), batch: int = 64,
                     device: torch.device | str = "cuda") -> np.ndarray:
    """Every frame's face crop (:func:`iter_face_crops`) as one
    (N, size[0], size[1], C) uint8 array."""
    crops = [c for _, c in iter_face_crops(frames, rows, size, batch, device)]
    if not crops:
        return np.zeros((0, *size, 3), np.uint8)
    return np.concatenate(crops)


def write_face_video(video_path: str, rows: Sequence[BBox], out_path: str,
                     size: Tuple[int, int] = (224, 224), batch: int = 64,
                     device: torch.device | str = "cuda") -> bool:
    """Crop every frame of a container to its face box and write a
    ``_faces`` mp4 (``cv2``; cremad_bbox_converter.py).  Frames are cropped
    as decoded (BGR) and written so, as the JAX writer does; the crops run
    on ``device``.  False when the container does not open or holds no
    frame."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return False
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (size[1], size[0]))

    def frames():
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield frame

    n = 0
    try:
        for _, crops in iter_face_crops(frames(), rows, size, batch, device):
            for crop in crops:
                writer.write(crop)
            n += len(crops)
    finally:
        cap.release()
        writer.release()
    return n > 0


def convert_folder_faces(video_dir: str, bbox_dir: str, output_dir: str,
                         size: Tuple[int, int] = (224, 224),
                         verbose: bool = True,
                         device: torch.device | str = "cuda") -> int:
    """For each video with a ``<stem>_bboxes.txt`` in ``bbox_dir``, write
    ``<stem>_faces.mp4`` to ``output_dir``; returns the count written."""
    from mmer_tpu_torch.preprocess.video import iter_video_files

    device = _crop_device(device)
    count = 0
    for video_path in iter_video_files(video_dir):
        stem = os.path.splitext(os.path.basename(video_path))[0]
        bbox_path = os.path.join(bbox_dir, f"{stem}_bboxes.txt")
        if not os.path.exists(bbox_path):
            continue
        out = os.path.join(output_dir, f"{stem}_faces.mp4")
        if write_face_video(video_path, read_bboxes_txt(bbox_path), out, size,
                            device=device):
            count += 1
            if verbose:
                print(f"[{count}] {out}", flush=True)
    return count


# ---------------------------------------------------------------------------
# serving-side sequence grouping
# ---------------------------------------------------------------------------

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
