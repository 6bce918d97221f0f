"""Score the port's face detector and tracker, the port of
``scripts/score_detector.py``.

The reference produces bbox ground truth with YOLOv11n-face
(cremad_extract_bboxes.py:39-56, lines ``frame,x1,y1,x2,y2,conf``).  This
tool scores:

- **against ground truth**, when a ``--gt`` folder of reference-format
  ``.txt`` files is given: per-box recall (a ground-truth face matched at
  IoU >= threshold) and mean IoU over the matches, for the raw detector and
  for the temporal tracker (``preprocess/faces.py:extract_frame_bboxes``);
- **standalone proxies** otherwise: the detection rate (frames with a box)
  and temporal stability (the spread of the box centres; the tracker's hit
  rate and mean centre step).

``--synthetic N`` scores composited clips whose boxes are known exactly
(translation, a scale sweep, clutter and noise, plus face-free distractor
clips); ``--cells`` the robustness cells (rotation 15° / 30°, occlusion 25 %
/ 40 %, two faces).  The portrait is the packaged face
(``assets/face_300x256.npy``) brought to the JAX script's 600x512 by the
port's bilinear resampling, so the clips' geometry is the JAX script's.
Writing and decoding the clips needs ``cv2``; :func:`score_frames` scores
decoded frames.

    python3 -m mmer_tpu_torch.scripts.score_detector --video clip.mp4
    python3 -m mmer_tpu_torch.scripts.score_detector --videos DIR --gt extracted_bboxes/
    python3 -m mmer_tpu_torch.scripts.score_detector --synthetic 4 --out eval.json
    python3 -m mmer_tpu_torch.scripts.score_detector --cells --out cells.json
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


def iou(a: np.ndarray, b: np.ndarray) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


def load_gt(path: str) -> Dict[int, List[np.ndarray]]:
    """Reference bbox txt (cremad_extract_bboxes.py:48-56) → frame → boxes."""
    out: Dict[int, List[np.ndarray]] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 5:
                continue
            frame = int(float(parts[0]))
            out.setdefault(frame, []).append(
                np.asarray([float(v) for v in parts[1:5]]))
    return out


def score_frames(frames: Iterable[np.ndarray], detector=None,
                 gt: Optional[Dict[int, List[np.ndarray]]] = None,
                 iou_thresh: float = 0.5, name: str = "") -> dict:
    """Score (H, W, 3) uint8 RGB frames: the raw detector frame by frame,
    then the temporal tracker over the same frames (see the module
    docstring for the keys)."""
    from mmer_tpu_torch.preprocess.faces import (best_bbox_per_frame,
                                                 default_detector,
                                                 extract_frame_bboxes)

    detector = detector or default_detector()
    frames = list(frames)
    detected = 0
    centers: List[Tuple[float, float]] = []
    matched = 0
    gt_boxes = 0
    ious: List[float] = []
    for n, rgb in enumerate(frames):
        dets = detector.detect(rgb)
        if dets:
            detected += 1
            x1, y1, x2, y2 = dets[0][:4]
            centers.append(((x1 + x2) / 2, (y1 + y2) / 2))
        if gt is not None and n in gt:
            # Per ground-truth box: detecting one of two faces scores 50 %.
            for g in gt[n]:
                gt_boxes += 1
                best = max((iou(np.asarray(d[:4], float), g)
                            for d in dets), default=0.0)
                if best >= iou_thresh:
                    matched += 1
                    ious.append(best)
    n = len(frames)

    # The tracker (the prep bbox extractor's path): its hit rate over all
    # frames and its stability (mean |centre step| between consecutive
    # covered frames).
    rows = extract_frame_bboxes(frames, detector, temporal=True)
    per = best_bbox_per_frame(rows)
    deltas = []
    for f in sorted(per):
        if f - 1 in per:
            a, b = np.asarray(per[f - 1]), np.asarray(per[f])
            ca = ((a[0] + a[2]) / 2, (a[1] + a[3]) / 2)
            cb = ((b[0] + b[2]) / 2, (b[1] + b[3]) / 2)
            deltas.append(float(np.hypot(cb[0] - ca[0], cb[1] - ca[1])))

    out = {
        "video": name,
        "frames": n,
        "detection_rate": detected / max(n, 1),
        "center_std_px": (np.asarray(centers).std(axis=0).tolist()
                          if len(centers) > 1 else None),
        "temporal_hit_rate": len(per) / max(n, 1),
        "temporal_mean_step_px": (float(np.mean(deltas)) if deltas
                                  else None),
    }
    if gt is not None:
        out.update({
            "gt_boxes": gt_boxes,
            "recall@iou{:.2f}".format(iou_thresh):
                matched / max(gt_boxes, 1),
            "mean_matched_iou": float(np.mean(ious)) if ious else 0.0,
        })
        # The tracker against the same boxes, on the same per-box basis: a
        # box matches against every row the tracker wrote for its frame.
        by_frame: Dict[int, List] = {}
        for r in rows:
            by_frame.setdefault(r[0], []).append(r[1:5])
        t_matched, t_total, t_ious = 0, 0, []
        for f, boxes in gt.items():
            for g in boxes:
                t_total += 1
                best = max((iou(np.asarray(b, float), g)
                            for b in by_frame.get(f, ())), default=0.0)
                if best >= iou_thresh:
                    t_matched += 1
                    t_ious.append(best)
        out.update({
            "temporal_recall@iou{:.2f}".format(iou_thresh):
                t_matched / max(t_total, 1),
            "temporal_mean_matched_iou":
                float(np.mean(t_ious)) if t_ious else 0.0,
        })
    return out


def score_video(video_path: str, detector=None,
                gt: Optional[Dict[int, List[np.ndarray]]] = None,
                iou_thresh: float = 0.5) -> dict:
    """:func:`score_frames` over a container's decoded frames (``cv2``):
    the keys of the JAX script's ``score_video``."""
    from mmer_tpu_torch.preprocess.video import iter_video_frames

    _, frames = iter_video_frames(video_path)
    return score_frames(frames, detector, gt, iou_thresh, name=video_path)


# ---- synthetic ground-truth suite and robustness cells ---------------------
#
# Clips composited from the portrait, so each frame's face box is known
# exactly: the canonical box is detected once on the still, and every
# ground-truth box is that box under the frame's placement.

def _portrait() -> np.ndarray:
    """The packaged face at the JAX script's portrait size, (600, 512, 3)
    uint8 RGB."""
    import torch

    from mmer_tpu_torch.ops.image import resize_batch
    from mmer_tpu_torch.scripts.full_chain import ASSET

    face = torch.from_numpy(np.load(ASSET))[None]
    out = resize_batch(face, (600, 512))[0]
    return torch.clamp(out, 0, 255).to(torch.uint8).numpy()


def _background(kind: int, h: int, w: int,
                rng: np.random.Generator) -> np.ndarray:
    if kind == 0:                                       # flat gray + noise
        return np.clip(rng.normal(110, 12, (h, w, 3)), 0, 255)
    if kind == 1:                                       # horizontal ramp
        ramp = np.linspace(30, 220, w)[None, :, None]
        return np.broadcast_to(ramp, (h, w, 3)).copy()
    blobs = rng.normal(128, 60, (h // 20, w // 20, 3))  # blurred clutter
    import cv2

    return np.clip(cv2.resize(blobs, (w, h),
                              interpolation=cv2.INTER_CUBIC), 0, 255)


def build_synthetic_suite(out_dir: str, n_face: int = 4, n_noface: int = 2,
                          frames: int = 60, size: Tuple[int, int] = (360, 480),
                          seed: int = 0):
    """Write GT-known mp4s; return [(path, gt_dict_or_None)].

    Face clips: the full portrait composited on a moving, scale-swept
    trajectory.  No-face clips: the same backgrounds with a moving
    skin-toned ellipse distractor (a hard negative for a Haar cascade).
    """
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    h, w = size
    sprite, canon = _sprite_and_canon()
    sh0, sw0 = sprite.shape[:2]

    suite = []
    for i in range(n_face):
        rng = np.random.default_rng(100 + seed + i)
        s0 = 0.45 + 0.17 * i                     # scale sweep across clips
        path = os.path.join(out_dir, f"synth_face_{i}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (w, h))
        if not vw.isOpened():
            raise RuntimeError("no mp4 encoder available")
        gt: Dict[int, List[np.ndarray]] = {}
        phase = rng.uniform(0, 2 * np.pi)
        for t in range(frames):
            s = s0 * (1.0 + 0.25 * np.sin(2 * np.pi * t / frames + phase))
            s = min(s, (h - 2) / sh0, (w - 2) / sw0)
            sw, sh = int(sw0 * s), int(sh0 * s)
            ox = int((w - sw) * (0.5 + 0.45 * np.sin(
                2 * np.pi * t / frames + phase)))
            oy = int((h - sh) * (0.5 + 0.45 * np.cos(
                4 * np.pi * t / frames + phase)))
            ox = int(np.clip(ox, 0, max(w - sw, 0)))
            oy = int(np.clip(oy, 0, max(h - sh, 0)))
            frame = _background(i % 3, h, w, rng)
            scaled = cv2.resize(sprite, (sw, sh))
            frame[oy:oy + sh, ox:ox + sw] = scaled
            frame = np.clip(frame + rng.normal(0, 4, frame.shape), 0, 255)
            vw.write(frame.astype(np.uint8)[:, :, ::-1])
            gt[t] = [np.asarray([ox + canon[0] * s, oy + canon[1] * s,
                                 ox + canon[2] * s, oy + canon[3] * s])]
        vw.release()
        suite.append((path, gt))

    for i in range(n_noface):
        rng = np.random.default_rng(900 + seed + i)
        path = os.path.join(out_dir, f"synth_noface_{i}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (w, h))
        if not vw.isOpened():
            raise RuntimeError("no mp4 encoder available")
        for t in range(frames):
            frame = _background(i % 3, h, w, rng)
            cx = int(w * (0.5 + 0.35 * np.sin(2 * np.pi * t / frames)))
            cy = int(h * (0.5 + 0.35 * np.cos(2 * np.pi * t / frames)))
            cv2.ellipse(frame, (cx, cy), (40, 55), 0, 0, 360,
                         (205, 170, 150), -1)          # skin-toned blob
            frame = np.clip(frame + rng.normal(0, 4, frame.shape), 0, 255)
            vw.write(frame.astype(np.uint8)[:, :, ::-1])
        vw.release()
        suite.append((path, None))
    return suite


# ---- robustness cells: rotation, occlusion, two faces: the conditions the
# reference's YOLO backend handles (cremad_extract_bboxes.py:39 runs conf=0.5
# over unconstrained frames) and a frontal Haar cascade may not.  Each cell
# reports the raw and the tracker's recall and matched IoU (the JAX
# package's numbers: artifacts/detector/robustness_cells.json).

def _sprite_and_canon():
    """(face-centred sprite, canonical face box in sprite coords): the box
    detected on the portrait (else its centre-upper third) with a 60 %
    margin, so that the sprite fits the frame across a scale sweep."""
    from mmer_tpu_torch.preprocess.faces import default_detector

    portrait = _portrait()
    ph, pw = portrait.shape[:2]
    dets = default_detector().detect(portrait)
    if dets:
        canon = np.asarray(dets[0][:4], float)
    else:
        canon = np.asarray([pw * 0.3, ph * 0.15, pw * 0.7, ph * 0.55])
    bw, bh = canon[2] - canon[0], canon[3] - canon[1]
    cx1 = int(max(canon[0] - 0.6 * bw, 0))
    cy1 = int(max(canon[1] - 0.6 * bh, 0))
    cx2 = int(min(canon[2] + 0.6 * bw, pw))
    cy2 = int(min(canon[3] + 0.6 * bh, ph))
    sprite = portrait[cy1:cy2, cx1:cx2]
    return sprite, canon - np.asarray([cx1, cy1, cx1, cy1], float)


def _paste_rotated(frame: np.ndarray, sprite: np.ndarray,
                   canon: np.ndarray, scale: float, angle_deg: float,
                   ox: int, oy: int) -> np.ndarray:
    """Composite a scaled+rotated sprite at (ox, oy); return the GT box
    (axis-aligned hull of the rotated canonical face corners)."""
    import cv2

    sh0, sw0 = sprite.shape[:2]
    sw, sh = int(sw0 * scale), int(sh0 * scale)
    scaled = cv2.resize(sprite, (sw, sh))
    m = cv2.getRotationMatrix2D((sw / 2, sh / 2), angle_deg, 1.0)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    rw, rh = int(sh * sin + sw * cos), int(sh * cos + sw * sin)
    m[0, 2] += rw / 2 - sw / 2
    m[1, 2] += rh / 2 - sh / 2
    rot = cv2.warpAffine(scaled, m, (rw, rh))
    mask = cv2.warpAffine(np.full((sh, sw), 255, np.uint8), m, (rw, rh))
    h, w = frame.shape[:2]
    ox = int(np.clip(ox, 0, max(w - rw, 0)))
    oy = int(np.clip(oy, 0, max(h - rh, 0)))
    region = frame[oy:oy + rh, ox:ox + rw]
    sel = mask[:region.shape[0], :region.shape[1]] > 127
    region[sel] = rot[:region.shape[0], :region.shape[1]][sel]

    corners = np.asarray([[canon[0], canon[1]], [canon[2], canon[1]],
                          [canon[2], canon[3]], [canon[0], canon[3]]],
                         float) * scale
    ones = np.concatenate([corners, np.ones((4, 1))], axis=1)
    rc = ones @ m.T                                    # rotated corners
    return np.asarray([ox + rc[:, 0].min(), oy + rc[:, 1].min(),
                       ox + rc[:, 0].max(), oy + rc[:, 1].max()])


def build_robustness_cells(out_dir: str, frames: int = 60,
                           size: Tuple[int, int] = (360, 480),
                           seed: int = 0):
    """GT-known clips per robustness cell → [(cell, path, gt)].

    Cells: in-plane rotation ±15°/±30° (oscillating), partial occlusion
    (25%/40% of the face area covered by a moving opaque bar), and
    two-face frames (two sprites at different scales on crossing paths).
    """
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    h, w = size
    sprite, canon = _sprite_and_canon()
    sh0, sw0 = sprite.shape[:2]
    out = []

    for cell, max_deg in (("rotation_15", 15.0), ("rotation_30", 30.0)):
        rng = np.random.default_rng(300 + seed)
        path = os.path.join(out_dir, f"synth_{cell}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (w, h))
        if not vw.isOpened():
            raise RuntimeError("no mp4 encoder available")
        gt: Dict[int, List[np.ndarray]] = {}
        s = min(0.65, (h - 40) / sh0, (w - 40) / sw0)
        for t in range(frames):
            angle = max_deg * np.sin(2 * np.pi * t / frames)
            ox = int((w - sw0 * s) * (0.5 + 0.3 * np.sin(
                2 * np.pi * t / frames)))
            oy = int((h - sh0 * s) * 0.4)
            frame = _background(0, h, w, rng)
            box = _paste_rotated(frame, sprite, canon, s, angle, ox, oy)
            frame = np.clip(frame + rng.normal(0, 4, frame.shape), 0, 255)
            vw.write(frame.astype(np.uint8)[:, :, ::-1])
            gt[t] = [box]
        vw.release()
        out.append((cell, path, gt))

    for cell, frac in (("occlusion_25", 0.25), ("occlusion_40", 0.40)):
        rng = np.random.default_rng(400 + seed)
        path = os.path.join(out_dir, f"synth_{cell}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             30.0, (w, h))
        if not vw.isOpened():
            raise RuntimeError("no mp4 encoder available")
        gt = {}
        s = min(0.65, (h - 40) / sh0, (w - 40) / sw0)
        sw, sh = int(sw0 * s), int(sh0 * s)
        for t in range(frames):
            ox = int((w - sw) * (0.5 + 0.3 * np.sin(2 * np.pi * t / frames)))
            oy = int((h - sh) * 0.4)
            frame = _background(0, h, w, rng)
            frame[oy:oy + sh, ox:ox + sw] = cv2.resize(sprite, (sw, sh))
            box = np.asarray([ox, oy, ox, oy], float) + canon * s
            # opaque bar sweeping over the face: covers `frac` of the face
            # area, alternating bottom/side coverage over time
            bw_, bh_ = box[2] - box[0], box[3] - box[1]
            if (t // 10) % 2 == 0:                     # bottom strip
                y1 = int(box[3] - frac * bh_)
                cv2.rectangle(frame, (int(box[0]) - 4, y1),
                              (int(box[2]) + 4, int(box[3]) + 4),
                              (70, 70, 70), -1)
            else:                                      # side strip
                x1 = int(box[2] - frac * bw_)
                cv2.rectangle(frame, (x1, int(box[1]) - 4),
                              (int(box[2]) + 4, int(box[3]) + 4),
                              (70, 70, 70), -1)
            frame = np.clip(frame + rng.normal(0, 4, frame.shape), 0, 255)
            vw.write(frame.astype(np.uint8)[:, :, ::-1])
            gt[t] = [box]
        vw.release()
        out.append((cell, path, gt))

    rng = np.random.default_rng(500 + seed)
    path = os.path.join(out_dir, "synth_two_face.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                         30.0, (w, h))
    if not vw.isOpened():
        raise RuntimeError("no mp4 encoder available")
    gt = {}
    s_a, s_b = 0.5, 0.38
    for t in range(frames):
        frame = _background(0, h, w, rng)
        boxes = []
        for s, phase, ypos in ((s_a, 0.0, 0.12), (s_b, np.pi, 0.58)):
            sw, sh = int(sw0 * s), int(sh0 * s)
            ox = int((w - sw) * (0.5 + 0.4 * np.sin(
                2 * np.pi * t / frames + phase)))
            oy = int(np.clip(h * ypos, 0, h - sh))
            frame[oy:oy + sh, ox:ox + sw] = cv2.resize(sprite, (sw, sh))
            boxes.append(np.asarray([ox, oy, ox, oy], float) + canon * s)
        frame = np.clip(frame + rng.normal(0, 4, frame.shape), 0, 255)
        vw.write(frame.astype(np.uint8)[:, :, ::-1])
        gt[t] = boxes
    vw.release()
    out.append(("two_face", path, gt))
    return out


def run_robustness_cells(frames: int, iou_thresh: float,
                         out: Optional[str]) -> dict:
    import json
    import tempfile

    key = f"recall@iou{iou_thresh:.2f}"
    tkey = f"temporal_recall@iou{iou_thresh:.2f}"
    cells = {}
    with tempfile.TemporaryDirectory() as td:
        for cell, path, gt in build_robustness_cells(td, frames):
            r = score_video(path, gt=gt, iou_thresh=iou_thresh)
            print(json.dumps({cell: r}), flush=True)
            cells[cell] = {
                "raw_recall": round(r[key], 4),
                "temporal_recall": round(r[tkey], 4),
                "mean_matched_iou": round(r["temporal_mean_matched_iou"], 4),
            }
    summary = {"frames_per_clip": frames, "iou_thresh": iou_thresh,
               "cells": cells}
    print(json.dumps({"robustness_summary": summary}))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def run_synthetic(n_face: int, n_noface: int, frames: int,
                  iou_thresh: float, out: Optional[str]) -> dict:
    import json
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        suite = build_synthetic_suite(td, n_face, n_noface, frames)
        face_rows, fp_rates = [], []
        for path, gt in suite:
            r = score_video(path, gt=gt, iou_thresh=iou_thresh)
            print(json.dumps(r), flush=True)
            if gt is not None:
                face_rows.append(r)
            else:
                fp_rates.append(r["temporal_hit_rate"])
    key = f"recall@iou{iou_thresh:.2f}"
    tkey = f"temporal_recall@iou{iou_thresh:.2f}"
    summary = {
        "face_clips": len(face_rows),
        "frames_per_clip": frames,
        "mean_raw_recall": round(float(np.mean(
            [r[key] for r in face_rows])), 4),
        "mean_temporal_recall": round(float(np.mean(
            [r[tkey] for r in face_rows])), 4),
        "mean_matched_iou": round(float(np.mean(
            [r["temporal_mean_matched_iou"] for r in face_rows])), 4),
        "per_clip_temporal_recall": [round(r[tkey], 4) for r in face_rows],
        "noface_clips": len(fp_rates),
        "false_positive_frame_rate": round(float(np.mean(fp_rates)), 4)
        if fp_rates else None,
    }
    print(json.dumps({"synthetic_summary": summary}))
    if out:
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Face-detector scorer")
    parser.add_argument("--video", action="append", default=[],
                        help="video file (repeatable)")
    parser.add_argument("--videos", default=None, help="directory of videos")
    parser.add_argument("--gt", default=None,
                        help="dir of <name>_bboxes.txt ground truth "
                             "(reference cremad_extract_bboxes.py format)")
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="run the GT-known synthetic suite with N face "
                             "clips (+ N//2+1 no-face distractor clips) "
                             "instead of scoring --video/--videos")
    parser.add_argument("--synthetic_frames", type=int, default=60)
    parser.add_argument("--cells", action="store_true",
                        help="run the robustness cells (rotation, "
                             "occlusion, two-face) instead of scoring "
                             "--video/--videos")
    parser.add_argument("--out", default=None,
                        help="write the synthetic summary JSON here")
    args = parser.parse_args(argv)

    if args.cells:
        run_robustness_cells(args.synthetic_frames, args.iou, args.out)
        return
    if args.synthetic:
        run_synthetic(args.synthetic, args.synthetic // 2 + 1,
                      args.synthetic_frames, args.iou, args.out)
        return

    paths = list(args.video)
    if args.videos:
        from mmer_tpu_torch.preprocess.video import iter_video_files
        paths.extend(iter_video_files(args.videos))
    if not paths:
        parser.error("no videos given")

    from mmer_tpu_torch.preprocess.faces import default_detector
    det = default_detector()

    rates, recalls = [], []
    for p in paths:
        gt = None
        if args.gt:
            stem = os.path.splitext(os.path.basename(p))[0]
            gt_path = os.path.join(args.gt, f"{stem}_bboxes.txt")
            if os.path.exists(gt_path):
                gt = load_gt(gt_path)
        res = score_video(p, det, gt, args.iou)
        rates.append(res["detection_rate"])
        if gt is not None:
            recalls.append(res[f"recall@iou{args.iou:.2f}"])
        print(res, flush=True)

    print(f"\nmean detection rate over {len(paths)} videos: "
          f"{np.mean(rates):.2%}")
    if recalls:
        print(f"mean recall@iou{args.iou:.2f}: {np.mean(recalls):.2%}")


if __name__ == "__main__":
    main()
