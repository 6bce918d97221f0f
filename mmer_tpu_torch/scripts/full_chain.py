"""One self-checking raw → serve chain, the port of ``scripts/full_chain.py``.

The reference's whole pipeline in one run: raw uncropped video →
per-frame face boxes (cremad_extract_bboxes.py) → face crops
(cremad_bbox_converter.py) → audio tracks as WAV
(cremad_video_to_audio_converter.py) → features (video_extractor.py,
voice_extractor.py) → training (train2.py) → serving
(back-end/app/libs/inference.py:356), with checks at the end.

:func:`run_chain` is the chain on decoded clips (frames and a waveform
each), so that it runs where no container codec does:

1. the tracker (``extract_frame_bboxes``) on every clip, its rows written
   as ``.txt`` files and read back equal;
2. 224² face crops on ``device`` (``iter_face_crops``, batches of 64);
3. each clip's waveform written as a WAV;
4. the extractors → (T, 768) video and (1024,) audio features, paired by
   ``dataset_from_feature_maps`` and held equal to the ``.npy`` disk
   route's arrays (``load_dataset``);
5. ``train.cli`` (z-score statistics, best checkpoint);
6. one held-out clip per emotion served with the trained head
   (``InferenceEngine.infer_frames``, or the caller's ``serve``) and a
   span-weighted vote over its windows.

:func:`main` wraps the chain in container I/O: it writes the synthetic raw
clips as mp4s with their tones muxed in as PCM tracks (``cv2``,
``serve/pcm_mp4.py``), decodes them back, runs the chain on the decoded
clips, and serves the held-out uploads over the HTTP server
(``serve/app.py``) on localhost.  ``chip_smoke.py`` runs the chain on the
synthetic frames themselves.

The clips: the packaged face (``assets/face_300x256.npy``, resized to 180²
by the port's bilinear resampling) translating over a textured 360x480
background, 40-80 frames each, with a label-coded tone.  Checks: the best
test accuracy above 80 %, and serving label recovery of at least 5 of 6.
Every clip shows the same face, so serving recovers the label only if the
audio leg (window slice → Wav2Vec2 → fusion) is live on the request path.

    python3 -m mmer_tpu_torch.scripts.full_chain                 # on the GPU
    python3 -m mmer_tpu_torch.scripts.full_chain --tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

EMOTIONS = ["NEU", "HAP", "SAD", "ANG", "FEA", "DIS"]
FRAME_HW = (360, 480)           # CREMA-D's frame size
FACE_SIDE = 180
FPS = 30.0
SAMPLE_RATE = 16000
# The face (ear to ear, brow to chin) as (x1, y1, x2, y2) in the 300x256
# packaged image.
FACE_RECT = (80, 50, 180, 160)
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "assets", "face_300x256.npy")


def packaged_face(side: int = FACE_SIDE) -> np.ndarray:
    """The packaged face resized to (side, side, 3) uint8 by the port's
    bilinear resampling (``ops/image.py:resize_batch``, on the CPU)."""
    import torch

    from mmer_tpu_torch.ops.image import resize_batch

    face = torch.from_numpy(np.load(ASSET))[None]
    out = resize_batch(face, (side, side))[0]
    return torch.clamp(out, 0, 255).to(torch.uint8).numpy()


def face_rect(side: int = FACE_SIDE) -> Tuple[float, float, float, float]:
    """:data:`FACE_RECT` in the (side, side) face's pixels."""
    x1, y1, x2, y2 = FACE_RECT
    sx, sy = side / 256, side / 300
    return (x1 * sx, y1 * sy, x2 * sx, y2 * sy)


def _rotate_rgb(img: np.ndarray, angle: float) -> np.ndarray:
    from mmer_tpu_torch.preprocess.imgproc import (rotation_matrix_2d,
                                                   warp_affine)

    h, w = img.shape[:2]
    m = rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
    return np.stack([warp_affine(np.ascontiguousarray(img[..., c]), m, (w, h))
                     for c in range(img.shape[2])], axis=-1)


def raw_clip_frames(face: np.ndarray, rng: np.random.Generator, n_frames: int,
                    hw: Tuple[int, int] = FRAME_HW,
                    tilt: Optional[Tuple[float, int, int]] = None,
                    occlusion: Optional[Tuple[float, int, int]] = None
                    ) -> np.ndarray:
    """(n_frames, H, W, 3) uint8 RGB frames of one raw clip: ``face`` with
    seeded jitter, translating slowly over a fixed textured background (the
    JAX script's clip).  ``tilt = (degrees, first, stop)`` rotates the face
    in-plane on frames [first, stop); ``occlusion = (fraction, first,
    stop)`` covers the bottom ``fraction`` of the face (:func:`face_rect`)
    with an opaque grey bar on those frames."""
    h, w = hw
    side = face.shape[0]
    bg = (rng.random((h, w, 3)) * 60 + 40).astype(np.uint8)
    x0 = int(rng.integers(0, w - side - 1))
    y0 = int(rng.integers(0, h - side - 1))
    dx, dy = rng.choice([-1, 1]) * 1.5, rng.choice([-1, 1]) * 1.0
    fx1, fy1, fx2, fy2 = face_rect(side)
    out = np.empty((n_frames, h, w, 3), np.uint8)
    for t in range(n_frames):
        x = int(np.clip(x0 + dx * t, 0, w - side))
        y = int(np.clip(y0 + dy * t, 0, h - side))
        sprite = np.clip(face.astype(np.int16)
                         + rng.integers(-8, 8, face.shape), 0, 255).astype(np.uint8)
        if tilt is not None and tilt[1] <= t < tilt[2]:
            sprite = _rotate_rgb(sprite, tilt[0])
        frame = bg.copy()
        frame[y:y + side, x:x + side] = sprite
        if occlusion is not None and occlusion[1] <= t < occlusion[2]:
            top = int(y + fy2 - occlusion[0] * (fy2 - fy1))
            frame[top:int(y + fy2) + 4, int(x + fx1) - 4:int(x + fx2) + 4] = 70
        out[t] = frame
    return out


def label_tone(emotion: int, n_frames: int, rng: np.random.Generator,
               fps: float = FPS, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """The clip's label-coded tone over its whole length (so every serving
    window hears it), with seeded noise: float32 at ``sample_rate``."""
    n = int(n_frames / fps * sample_rate)
    tone = 0.3 * np.sin(2 * np.pi * (200 + 60 * emotion)
                        * np.arange(n) / sample_rate)
    return (tone + rng.normal(scale=0.05, size=n)).astype(np.float32)


def clip_key(actor: int, emotion: int) -> str:
    """A CREMA-D-style clip name, ``{actor}_IEO_{EMO}_XX``."""
    return f"{actor}_IEO_{EMOTIONS[emotion]}_XX"


def span_vote(classes: Sequence[str], max_seq_len: int) -> str:
    """The clip's label from its windows' classes: window s of n covers
    ``min(window, n - s)`` subchunks, with the engine's window clamp
    ``min(5, max_seq_len - 1)`` (``serve/engine.py:_clamp_window``), and a
    class's score is its windows' summed spans."""
    n = len(classes)
    window = min(5, int(max_seq_len) - 1)
    score: dict = {}
    for s, c in enumerate(classes):
        score[c] = score.get(c, 0) + min(window, n - s)
    return max(score, key=score.get)


@dataclass
class Clip:
    """One decoded raw clip: (n, H, W, 3) uint8 RGB frames at :data:`FPS`,
    its float32 waveform at :data:`SAMPLE_RATE`, and the container it was
    decoded from, if any."""
    key: str
    emotion: int
    frames: np.ndarray
    wave: np.ndarray
    path: Optional[str] = None


def make_clips(actors: int, rng: np.random.Generator,
               frames: Tuple[int, int] = (40, 81), first_actor: int = 1001,
               extras: Optional[dict] = None) -> Iterable[Clip]:
    """Yield ``actors`` x 6 raw clips, made one at a time from ``rng``:
    actor by actor, emotion by emotion, each ``frames`` [lo, hi) frames
    long.  ``extras`` maps an emotion index to :func:`raw_clip_frames`'s
    ``tilt`` / ``occlusion`` for that emotion's clips."""
    face = packaged_face()
    for actor in range(first_actor, first_actor + actors):
        for ei in range(len(EMOTIONS)):
            n = int(rng.integers(*frames))
            pixels = raw_clip_frames(face, rng, n, **(extras or {}).get(ei, {}))
            yield Clip(clip_key(actor, ei), ei, pixels, label_tone(ei, n, rng))


def write_raw_clip(clip: Clip, folder: str) -> str:
    """``clip`` as ``folder/{key}.mp4`` (``cv2``, mp4v) with its tone muxed
    in as a PCM track; returns the path."""
    import cv2

    from mmer_tpu_torch.serve.pcm_mp4 import mux_pcm_into_file

    h, w = clip.frames.shape[1:3]
    path = os.path.join(folder, f"{clip.key}.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (w, h))
    if not writer.isOpened():
        raise RuntimeError("no mp4 encoder in this cv2 build")
    for frame in clip.frames:
        writer.write(frame[:, :, ::-1])
    writer.release()
    mux_pcm_into_file(path, clip.wave, SAMPLE_RATE)
    return path


def decode_raw_clip(path: str, key: str, emotion: int) -> Clip:
    """A container's frames (``iter_video_frames``) and audio track
    (``extract_audio_track``: the PCM demux) as a :class:`Clip`."""
    from mmer_tpu_torch.preprocess.audio import extract_audio_track
    from mmer_tpu_torch.preprocess.video import iter_video_frames

    _, frames = iter_video_frames(path)
    pixels = np.stack(list(frames))
    wave = extract_audio_track(path, SAMPLE_RATE)
    if wave is None:
        raise RuntimeError(f"{path}: no decodable audio track")
    return Clip(key, emotion, pixels, wave, path)


@dataclass
class ChainResult:
    """What :func:`run_chain` measured: the tracker's rows by source and its
    host seconds, the crops' seconds (copies included) and, for crops off
    the CPU, their worst grey-level distance from the CPU's, the clip count,
    the training rows, and each probe's (emotion, window classes, vote)."""
    track: object
    track_s: float
    crop_s: float
    crop_worst: Optional[int]
    clips: int
    embed_s: float
    results: list
    train_s: float
    votes: List[Tuple[str, List[str], Optional[str]]] = field(default_factory=list)
    serve_s: float = 0.0

    @property
    def best_acc(self) -> float:
        return max((r.get("test_acc", 0.0) for r in self.results), default=0.0)

    @property
    def hits(self) -> int:
        return sum(emo == vote for emo, _, vote in self.votes)

    @property
    def ok(self) -> bool:
        """The JAX script's two thresholds."""
        return self.best_acc > 80 and self.hits >= 5 / 6 * len(self.votes)


def _stored(rows):
    """Rows as ``write_bboxes_txt`` stores them (1 and 4 decimals)."""
    return [(f, *(float(f"{v:.1f}") for v in r[:4]), float(f"{r[4]:.4f}"))
            for f, *r in rows]


def serve_frames(engine, probes: Sequence[Clip]) -> List[List[str]]:
    """Each probe's window classes through ``InferenceEngine.infer_frames``,
    detecting every third frame as the script's uploads ask."""
    return [[i["class"] for i in engine.infer_frames(
        iter(p.frames), FPS, p.wave, detect_every=3)["inference"]]
        for p in probes]


def serve_http(engine, probes: Sequence[Clip]) -> List[List[str]]:
    """Each probe's container uploaded to the HTTP server around
    ``engine`` on localhost; its window classes."""
    from http.server import ThreadingHTTPServer

    from mmer_tpu_torch.serve.app import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = []
    try:
        for p in probes:
            res = _post_upload(base, p.path)
            assert set(res) == {"bounding_box", "inference"}, res.keys()
            out.append([i["class"] for i in res["inference"]])
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def run_chain(clips: Iterable[Clip], probes: Sequence[Clip], workdir: str,
              device, *, vivit_cfg=None, wav_cfg=None, epochs: int = 60,
              serve: Callable = serve_frames,
              log: Callable[[str], None] = print) -> ChainResult:
    """The chain on decoded clips (see the module docstring), its files
    under ``workdir``.  ``clips`` is consumed once, a clip at a time; the
    held-out ``probes`` are served after training.  Crops made off the CPU
    are held batch by batch to the same crops on the CPU (within one grey
    level).  Raises AssertionError where a stage's own check fails; the
    thresholds are the caller's (:attr:`ChainResult.ok`)."""
    import torch

    from mmer_tpu_torch.config import DataConfig, ModelConfig
    from mmer_tpu_torch.core.artifacts import (save_audio_features,
                                               save_video_features)
    from mmer_tpu_torch.data.catalog import sample_key
    from mmer_tpu_torch.data.pipeline import load_dataset
    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.preprocess.audio import audio_output_name, write_wav
    from mmer_tpu_torch.preprocess.extract import (VideoFeatureExtractor,
                                                   dataset_from_feature_maps,
                                                   iter_audio_embeddings)
    from mmer_tpu_torch.preprocess.faces import (HaarFaceDetector, TrackStats,
                                                 extract_frame_bboxes,
                                                 iter_face_crops,
                                                 read_bboxes_txt,
                                                 write_bboxes_txt)
    from mmer_tpu_torch.preprocess.video import (feature_output_name,
                                                 frames_to_chunks)
    from mmer_tpu_torch.serve.engine import InferenceEngine
    from mmer_tpu_torch.train.cli import main as train_main

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    detector = HaarFaceDetector()
    dirs = {k: os.path.join(workdir, k)
            for k in ("bboxes", "audio", "video_features", "audio_features",
                      "runs")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    # 1-3: boxes, crops, WAVs, a clip at a time.
    track, track_s, crop_s, crop_worst = TrackStats(), 0.0, 0.0, None
    keys, chunks = [], []
    for clip in clips:
        stats = TrackStats()
        t0 = time.perf_counter()
        rows = extract_frame_bboxes(clip.frames, detector, stats=stats)
        track_s += time.perf_counter() - t0
        for k in ("frames", "full", "relaxed", "tracked", "interpolated"):
            setattr(track, k, getattr(track, k) + getattr(stats, k))
        txt = os.path.join(dirs["bboxes"], f"{clip.key}_bboxes.txt")
        write_bboxes_txt(txt, rows)
        if read_bboxes_txt(txt) != _stored(rows):
            raise AssertionError(f"{clip.key}: the .txt round trip differs "
                                 "from the tracker's rows")
        sync()
        t0 = time.perf_counter()
        crops = [c for _, c in iter_face_crops(clip.frames, rows, device=device)]
        sync()
        crop_s += time.perf_counter() - t0
        if device.type != "cpu":
            for got, (_, want) in zip(crops, iter_face_crops(
                    clip.frames, rows, device="cpu")):
                crop_worst = max(crop_worst or 0, int(np.abs(
                    got.astype(int) - want.astype(int)).max()))
        chunks.append(frames_to_chunks(np.concatenate(crops), 32, "uint8"))
        write_wav(os.path.join(dirs["audio"], f"{clip.key}.wav"), clip.wave)
        keys.append(clip.key)
    if crop_worst is not None and crop_worst > 1:
        raise AssertionError(f"a crop on {device} is {crop_worst} grey levels "
                             "from the CPU's")
    token_counts = sorted({len(c) for c in chunks})
    log(f"      {len(keys)} clips, {track.frames} frames: tracker "
        f"{track_s / track.frames * 1e3:.2f} ms a frame (host); rows full "
        f"{track.full}, relaxed {track.relaxed}, tracked {track.tracked}, "
        f"interpolated {track.interpolated}; crops "
        f"{crop_s / track.frames * 1e3:.3f} ms a frame; chunks a clip "
        f"{token_counts}")
    if token_counts[0] < 2 or len(token_counts) < 2:
        raise AssertionError(f"expected mixed multi-chunk clips, got "
                             f"{token_counts} chunks a clip")

    # 4: features, the raw-media tail against the disk route.
    t0 = time.perf_counter()
    extractor = VideoFeatureExtractor(vivit_cfg, device=device)
    feats = extractor.embed_chunks(np.concatenate(chunks))
    video_feats, offset = {}, 0
    for key, c in zip(keys, chunks):
        name = feature_output_name(os.path.join(workdir, f"{key}_faces.mp4"),
                                   workdir)
        video_feats[sample_key(name)] = feats[offset:offset + len(c)]
        save_video_features(os.path.join(dirs["video_features"], name),
                            video_feats[sample_key(name)])
        offset += len(c)
    del chunks
    embedder = AudioEmbedder(wav_cfg, device=device)
    audio_feats = {}
    for path, emb in iter_audio_embeddings(dirs["audio"], embedder, 64,
                                           verbose=False):
        name = audio_output_name(os.path.basename(path))
        audio_feats[sample_key(name)] = emb
        save_audio_features(os.path.join(dirs["audio_features"], name), emb)
    sync()
    embed_s = time.perf_counter() - t0
    (rd, rs), (dd, ds) = (
        dataset_from_feature_maps(video_feats, audio_feats, DataConfig()),
        load_dataset(DataConfig(video_feat_dir=dirs["video_features"],
                                audio_feat_dir=dirs["audio_features"])))
    same = (rd.keys == dd.keys and rd.max_chunks == dd.max_chunks
            and all(np.array_equal(getattr(rd, f), getattr(dd, f))
                    for f in ("video", "audio", "pad_mask", "labels", "lengths",
                              "video_mean", "video_std", "audio_mean",
                              "audio_std"))
            and all(np.array_equal(a, b) for a, b in
                    zip((rs.train, rs.val, rs.test, rs.class_weights),
                        (ds.train, ds.val, ds.test, ds.class_weights))))
    if not same or rd.num_samples != len(keys):
        raise AssertionError("the raw-media arrays differ from the disk "
                             "route's")
    log(f"      {len(feats)} chunks and {len(audio_feats)} clips embedded in "
        f"{embed_s:.2f} s; the raw-media arrays ({rd.num_samples} samples, "
        f"max_chunks {rd.max_chunks}) equal load_dataset's of the .npy files")

    # 5: fused training: the JAX script trains with --fused, and a run from
    # seed s draws what the JAX run from seed s draws only with the same flag.
    t0 = time.perf_counter()
    out = train_main([
        "--batch_size", "16", "--num_epochs", str(epochs), "--lr", "1e-4",
        "--video_feat_dir", dirs["video_features"],
        "--audio_feat_dir", dirs["audio_features"],
        "--output_dir", dirs["runs"], "--device", str(device), "--fused"])
    sync()
    result = ChainResult(track, track_s, crop_s, crop_worst, len(keys),
                         embed_s, out.results, time.perf_counter() - t0)
    log(f"      fused training: {len(out.results)} epochs in {result.train_s:.2f} s, "
        f"best test acc {result.best_acc:.1f}%")

    # 6: serving.  The trainer sizes max_seq_len to the dataset; the engine
    # loads the checkpoint at the trained shape, and serves with the
    # extractors that made the training features.
    hp = out.hyperparameters
    engine = InferenceEngine(
        device, model_cfg=ModelConfig(max_seq_len=hp["max_seq_len"],
                                      fused_dim=hp["fused_dim"],
                                      fusion_layers=hp["num_layers"]),
        vivit_cfg=vivit_cfg, wav_cfg=wav_cfg,
        fusion_params_path=out.best_model_path,
        norm_stats_path=out.norm_stats_path, detector=detector)
    engine._video_extractor, engine._audio_embedder = extractor, embedder
    t0 = time.perf_counter()
    for p, classes in zip(probes, serve(engine, probes)):
        emo = EMOTIONS[p.emotion]
        vote = span_vote(classes, hp["max_seq_len"]) if classes else None
        result.votes.append((emo, classes, vote))
        log(f"      {emo}: windows={classes} -> {vote} "
            f"{'OK' if vote == emo else 'MISS'}")
    sync()
    result.serve_s = time.perf_counter() - t0
    return result


def _tiny_configs():
    from mmer_tpu_torch.config import ViViTConfig, Wav2Vec2Config

    return (ViViTConfig(image_size=(224, 224), patch_size=(16, 16),
                        num_frames=32, tubelet_size=2, dim=768, depth=1,
                        heads=2, dim_head=32, mlp_dim=128,
                        compute_dtype="float32"),
            # Four conv layers (the JAX script's tiny config has the first
            # two): a 3 s batch of 64 makes 1,199 frames, not 4,799, so its
            # plain attention takes ~0.7 GB on a CPU host, not ~12 GB.
            Wav2Vec2Config(hidden_dim=1024, num_layers=1, num_heads=2,
                           ffn_dim=128, conv_dims=(32, 32, 32, 32),
                           conv_strides=(5, 2, 2, 2), conv_kernels=(10, 3, 3, 2),
                           num_conv_pos_embeddings=16,
                           num_conv_pos_embedding_groups=4,
                           compute_dtype="float32"))


def _post_upload(base: str, path: str) -> dict:
    with open(path, "rb") as f:
        video_bytes = f.read()
    boundary = "fullchainbound"
    body = (f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="file"; '
            f'filename="{os.path.basename(path)}"\r\n'
            "Content-Type: video/mp4\r\n\r\n").encode() + video_bytes \
        + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        base + "/infer/?detect_every=3", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "mmer_full_chain"))
    ap.add_argument("--actors", type=int, default=12,
                    help="training actors, >= 10 so the stratified 80/10/10 "
                         "split has every class in each fold; one more "
                         "actor's clips are held out and served")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny extractors (a CPU rehearsal); default: the "
                         "full-size ViViT and Wav2Vec2-large")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("full_chain: CUDA device requested but "
                           "torch.cuda.is_available() is False (pass "
                           "--device cpu to run on the CPU)")
    t_all = time.time()
    root = args.root
    if os.path.isdir(root):
        shutil.rmtree(root)
    raw = os.path.join(root, "raw_videos")
    os.makedirs(raw)
    rng = np.random.default_rng(0)

    def through_containers(clips):
        """Each clip written as an mp4 with its PCM track, decoded back."""
        for clip in clips:
            yield decode_raw_clip(write_raw_clip(clip, raw), clip.key,
                                  clip.emotion)

    print(f"[1/7] {args.actors * 6} raw uncropped clips (360x480, 40-80 "
          f"frames, PCM tone tracks) written to {raw} and decoded; [2-4/7] "
          "boxes, face crops, WAVs", flush=True)
    probes = list(through_containers(
        make_clips(1, rng, first_actor=1001 + args.actors)))
    vivit_cfg, wav_cfg = _tiny_configs() if args.tiny else (None, None)
    result = run_chain(through_containers(make_clips(args.actors, rng)),
                       probes, os.path.join(root, "chain"), device,
                       vivit_cfg=vivit_cfg, wav_cfg=wav_cfg,
                       epochs=args.epochs, serve=serve_http)
    print(f"\nFULL-CHAIN RESULT: train best test acc {result.best_acc:.1f}%, "
          f"serving label recovery {result.hits}/{len(result.votes)}, "
          f"wall {time.time() - t_all:.0f}s", flush=True)
    print("FULL-CHAIN " + ("OK" if result.ok else "FAILED"), flush=True)
    if not args.keep:
        shutil.rmtree(root)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
