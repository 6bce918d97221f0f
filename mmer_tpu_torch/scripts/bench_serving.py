"""Serving latency benchmark, the port of ``scripts/bench_serving.py``: p50 /
p95 request latency, cold against warm start.

What the serving hot path costs a request (reference
back-end/app/libs/inference.py:393-520) at the full default widths
(ViViT-B/12, Wav2Vec2-large, the default fusion) on one device:

  1. the first request (``explain=true``): cold with ``--no_warmup``, else
     after ``InferenceEngine.warmup``;
  2. warmup's wall time (its phases on stderr);
  3. warm latencies over ``--requests`` distinct uploads, ``explain`` off
     and on, p50 / p95;
  4. two novel-resolution first requests: 310x280, a new resolution in the
     300x256 uploads' bucket (320, 320), and 700x500, a new bucket (640,
     720);
  5. with ``--long_upload_frames N``, one long upload's latency and
     peak-RSS delta: the bounded-memory streaming case.

Uploads are made here, each with per-seed ±8 pixel jitter a frame and a
per-seed tone plus noise as its audio track (``--no_audio``: none), so that
no two requests are identical.  ``--route``:

- ``file`` (the default, the JAX script's route): mp4 files of
  matplotlib's grace_hopper written with ``cv2`` and a PCM track muxed by
  ``serve/pcm_mp4``, through ``infer_file_bytes``.  It needs ``cv2``, PIL
  and matplotlib, which the GPU machine does not have;
- ``frames``: the same frames and waveform without a container, through
  ``infer_frames``.  The frames are made from the packaged face
  (``assets/face_300x256.npy``, ``cv2``'s resize of grace_hopper to
  300x256) and the novel-resolution legs paste it by the same aspect rule,
  resized by the port's bilinear resampling (``ops/image.resize_batch``).

Stderr carries the per-leg lines and a ``cold start:`` JSON line (warmup's
phases and launches, kernel libraries built during and after warmup); the
last line of stdout is one JSON object with the JAX script's keys and
``route``.

    python3 -m mmer_tpu_torch.scripts.bench_serving --route frames
    python3 -m mmer_tpu_torch.scripts.bench_serving --route frames --no_warmup
    python3 -m mmer_tpu_torch.scripts.bench_serving --route frames \\
        --warmup_resolutions 300x256 --warmup_upload
    python3 -m mmer_tpu_torch.scripts.bench_serving --device cpu   # full width: slow

It runs on the card unless ``--device cpu``; without CUDA it refuses to
start.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

FACE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "assets", "face_300x256.npy")
FPS = 30.0


def _fit(img: np.ndarray, size: Tuple[int, int],
         resize: Callable[[np.ndarray, Tuple[int, int]], np.ndarray]
         ) -> np.ndarray:
    """``img`` brought to ``size`` (width, height): resized when the aspect
    ratios agree, else pasted at its aspect on a grey canvas (a bare resize
    squashes the portrait, and the frontal cascade then finds no face)."""
    w_t, h_t = size
    h_s, w_s = img.shape[:2]
    if abs(w_t / h_t - w_s / h_s) < 0.05:
        return resize(img, size)
    s = min(w_t / w_s, h_t / h_s)
    nw, nh = int(w_s * s), int(h_s * s)
    face = resize(img, (nw, nh))
    canvas = np.full((h_t, w_t, 3), 96, np.uint8)
    y0, x0 = (h_t - nh) // 2, (w_t - nw) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = face
    return canvas


def _jittered(img: np.ndarray, frames: int, rng) -> Iterator[np.ndarray]:
    for _ in range(frames):
        jitter = img.astype(np.int16) + rng.integers(-8, 8, img.shape)
        yield np.clip(jitter, 0, 255).astype(np.uint8)


def _tone(frames: int, fps: float, sample_rate: int, seed: int,
          rng) -> np.ndarray:
    t = np.arange(int(frames / fps * sample_rate)) / sample_rate
    return (0.4 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def make_face_video(path: str, frames: int, seed: int, size=(256, 300),
                    fps: float = 30.0, audio: bool = True,
                    sample_rate: int = 16000) -> None:
    """An mp4 of ``frames`` jittered grace_hopper frames at ``size`` (width,
    height), with a tone-plus-noise PCM track unless ``audio`` is False:
    the JAX script's upload, byte for byte."""
    import cv2
    from matplotlib import cbook
    from PIL import Image

    img = np.asarray(Image.open(
        cbook.get_sample_data("grace_hopper.jpg", asfileobj=False)))
    img = _fit(img, size, cv2.resize)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    if not w.isOpened():
        raise RuntimeError("no mp4 encoder in this cv2 build")
    rng = np.random.default_rng(seed)
    for frame in _jittered(img, frames, rng):
        w.write(frame[:, :, ::-1])
    w.release()
    if audio:
        from mmer_tpu_torch.serve.pcm_mp4 import mux_pcm_into_file

        mux_pcm_into_file(path, _tone(frames, fps, sample_rate, seed, rng),
                          sample_rate)


def _torch_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    import torch

    from mmer_tpu_torch.ops.image import resize_batch

    w, h = size
    out = resize_batch(torch.from_numpy(img)[None], (h, w))[0]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


def make_face_frames(frames: int, seed: int, size=(256, 300),
                     fps: float = 30.0, audio: bool = True,
                     sample_rate: int = 16000
                     ) -> Tuple[Iterator[np.ndarray], Optional[np.ndarray]]:
    """:func:`make_face_video`'s upload without a container, from the
    packaged face: (the RGB frames, made one at a time as they are
    consumed, the waveform or None).  The draws are the video's: at the
    default size the frames equal the ones it encodes."""
    img = _fit(np.load(FACE), size, _torch_resize)
    wave = None
    if audio:
        rng = np.random.default_rng(seed)
        for _ in _jittered(img, frames, rng):     # the frames' draws first
            pass
        wave = _tone(frames, fps, sample_rate, seed, rng)
    return _jittered(img, frames, np.random.default_rng(seed)), wave


def _require_items(res: dict, what: str) -> None:
    """A leg that finds no face measures nothing: fail the run."""
    if not res["inference"]:
        raise RuntimeError(f"no inference items on {what}")


def pctl(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def build_engine(device):
    """The engine under test: the default widths on ``device``."""
    from mmer_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--frames", type=int, default=96,
                    help="frames per upload (96 = 3 subchunks @ 32)")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip warmup() and measure the cold first request")
    ap.add_argument("--detect_every", type=int, default=3)
    ap.add_argument("--no_audio", action="store_true",
                    help="uploads WITHOUT an audio track (the video-only "
                         "control)")
    ap.add_argument("--warmup_resolutions", default="",
                    help="comma-separated HxW formats passed to warmup() "
                         "(serve/app.py's flag): with the upload format "
                         "listed, the first request's crop shape is warm")
    ap.add_argument("--warmup_upload", action="store_true",
                    help="pass a sample upload (distinct from the measured "
                         "ones) to warmup() as its end-to-end replay phase "
                         "(serve/app.py's --warmup_upload; decoded frames on "
                         "the frames route)")
    ap.add_argument("--long_upload_frames", type=int, default=0,
                    help="also run ONE long upload of this many frames "
                         "(e.g. 3600 = 2 min @ 30fps) and report its "
                         "latency + peak RSS delta (the bounded-memory "
                         "streaming case)")
    ap.add_argument("--route", choices=("file", "frames"), default="file",
                    help="file: mp4 bytes through infer_file_bytes (needs "
                         "cv2); frames: the same frames and waveform through "
                         "infer_frames (default: file)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda refuses to start without a GPU "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    # Validated before the engine and the uploads are made.
    resolutions = []
    for part in filter(None, args.warmup_resolutions.split(",")):
        try:
            h, w = part.lower().strip().split("x")
            resolutions.append((int(h), int(w)))
        except ValueError:
            ap.error(f"--warmup_resolutions entry {part!r} is not HxW "
                     f"(e.g. '480x640')")

    import torch

    from mmer_tpu_torch.ops import _build
    from mmer_tpu_torch.scripts.timing import resolve_device

    device = resolve_device(args.device)
    engine = build_engine(device)
    audio = not args.no_audio
    log = lambda *a: print(*a, file=sys.stderr, flush=True)   # noqa: E731

    with tempfile.TemporaryDirectory(prefix="bench_serving_") as tmp:

        def upload(frames: int, seed: int, size=(256, 300), lazy=False):
            """One upload: mp4 bytes (file route) or (frames, waveform)."""
            if args.route == "file":
                p = os.path.join(tmp, f"s{seed}_{size[0]}x{size[1]}.mp4")
                make_face_video(p, frames, seed=seed, size=size, audio=audio)
                with open(p, "rb") as f:
                    return f.read()
            it, wave = make_face_frames(frames, seed, size=size, audio=audio)
            return (it if lazy else list(it)), wave

        def request(up, name: str, explain: bool = False):
            if args.route == "file":
                return engine.infer_file_bytes(up, name, explain=explain,
                                               detect_every=args.detect_every)
            frames, wave = up
            return engine.infer_frames(iter(frames), FPS, wave,
                                       explain=explain,
                                       detect_every=args.detect_every)

        uploads = [upload(args.frames, i) for i in range(args.requests + 1)]
        builds_in_warmup = 0
        if not args.no_warmup:
            sample = sample_frames = None
            if args.warmup_upload:
                # A seed outside the uploads' [0, requests]: the replayed
                # sample is none of the measured uploads.
                up = upload(args.frames, args.requests + 2)
                if args.route == "file":
                    sample = up
                else:
                    sample_frames = (up[0], FPS, up[1])
            builds0 = _build.builds
            t0 = time.perf_counter()
            engine.warmup(resolutions=resolutions, sample_upload=sample,
                          sample_frames=sample_frames)
            log(f"warmup: {time.perf_counter() - t0:.1f}s")
            builds_in_warmup = _build.builds - builds0
        builds_after0 = _build.builds

        # The first request: cold with --no_warmup, else already warmed.
        t0 = time.perf_counter()
        r = request(uploads[0], "u0.mp4", explain=True)
        first = time.perf_counter() - t0
        _require_items(r, "the face video")
        log(f"first request (explain=true): {first:.2f}s "
            f"[{'COLD' if args.no_warmup else 'warmed'}]")

        results = {}
        for explain in (False, True):
            lats = []
            for i in range(1, args.requests + 1):
                t0 = time.perf_counter()
                request(uploads[i], f"u{i}.mp4", explain=explain)
                lats.append(time.perf_counter() - t0)
            results[explain] = lats
            log(f"explain={explain}: p50={pctl(lats, 50)*1e3:.0f}ms "
                f"p95={pctl(lats, 95)*1e3:.0f}ms "
                f"(n={len(lats)}, {args.frames} frames/upload)")

        # Novel-resolution first requests: 310x280 lands in the uploads'
        # bucket (320, 320), so its crop shape is warm; 700x500 lands in a
        # new bucket (640, 720), whose crop shape runs for the first time.
        # Same frame count as the loop above, so the other shapes are warm.
        res_stats = {}
        for label, (w_, h_) in (("same_bucket_novel_res", (310, 280)),
                                ("new_bucket_first_req", (700, 500))):
            up = upload(args.frames, 77, size=(w_, h_))
            t0 = time.perf_counter()
            r = request(up, f"{label}.mp4")
            res_stats[label + "_s"] = round(time.perf_counter() - t0, 2)
            _require_items(r, label)
            log(f"{label} ({h_}x{w_}): {res_stats[label + '_s']}s")

        long_stats = None
        if args.long_upload_frames:
            import resource

            # The frames route makes the long upload's frames as they are
            # consumed, in the request's time, as the file route decodes.
            up = upload(args.long_upload_frames, 99, lazy=True)
            decoded_mb = args.long_upload_frames * 300 * 256 * 3 / 1e6
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            t0 = time.perf_counter()
            r = request(up, "long.mp4")
            t_long = time.perf_counter() - t0
            rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            _require_items(r, "the long video")
            if device.type == "cuda":
                log(f"long upload: peak device memory "
                    f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
            long_stats = {
                "frames": args.long_upload_frames,
                "latency_s": round(t_long, 2),
                "decoded_rgb_mb": round(decoded_mb, 0),
                "peak_rss_delta_mb": round(rss1 - rss0, 1),
            }
            log(f"long upload ({args.long_upload_frames} frames, "
                f"{decoded_mb:.0f} MB decoded RGB): {t_long:.1f}s, "
                f"peak-RSS delta {rss1 - rss0:.0f} MB")

    log("cold start: " + json.dumps({
        "route": args.route, "warmed": not args.no_warmup,
        "warmup": engine.last_warmup,
        "kernel_builds_in_warmup": builds_in_warmup,
        "kernel_builds_after_warmup": _build.builds - builds_after0}))
    print(json.dumps({
        **({"long_upload": long_stats} if long_stats else {}),
        "first_request_s": round(first, 2),
        "warmed": not args.no_warmup,
        "warmup_resolutions": args.warmup_resolutions,
        "warmup_upload": bool(args.warmup_upload),
        "audio_live": audio,
        "frames_per_upload": args.frames,
        "detect_every": args.detect_every,
        "p50_ms": round(pctl(results[False], 50) * 1e3, 1),
        "p95_ms": round(pctl(results[False], 95) * 1e3, 1),
        "explain_p50_ms": round(pctl(results[True], 50) * 1e3, 1),
        "explain_p95_ms": round(pctl(results[True], 95) * 1e3, 1),
        **res_stats,
        "route": args.route,
    }), flush=True)


if __name__ == "__main__":
    main()
