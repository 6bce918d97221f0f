"""End-to-end demo, the port of ``scripts/e2e_demo.py``: face-crop videos +
audio → extraction → training.

Writes a small CREMA-D-style dataset (224² face videos of the packaged face
with seeded jitter, 40-80 frames each, and a label-coded tone a clip as a
WAV), runs both extractors at full size (ViViT-B, Wav2Vec2-large), then
trains the fusion classifier on the fresh features.  The tones encode the
label, so a sound pipeline reaches ~100 % test accuracy: a self-checking
run of the whole extract → train path.  ``--hbm`` takes the raw-media route
instead (``train.cli --raw_videos / --raw_audio``: no ``.npy`` written).
Writing the videos needs ``cv2``.

    python3 -m mmer_tpu_torch.scripts.e2e_demo [--root DIR] [--actors 12] [--hbm]
    python3 -m mmer_tpu_torch.scripts.e2e_demo --device cpu   # a CPU rehearsal
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import wave
from typing import Optional, Sequence

import numpy as np

from mmer_tpu_torch.scripts.full_chain import (EMOTIONS, SAMPLE_RATE,
                                               clip_key, packaged_face)


def generate_dataset(root: str, actors: int, frames: tuple = (40, 81)) -> None:
    """Mixed-length face clips (40-80 frames: 2-3 subchunks of 32), so chunk
    packing and padding and T >= 2 fusion run through both the disk and the
    raw-media routes; one 1 s tone a clip."""
    import cv2

    vdir, adir = os.path.join(root, "videos"), os.path.join(root, "audio")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(adir, exist_ok=True)
    img224 = packaged_face(224)
    rng = np.random.default_rng(0)
    for actor in range(1001, 1001 + actors):
        for ei in range(len(EMOTIONS)):
            key = clip_key(actor, ei)
            writer = cv2.VideoWriter(
                os.path.join(vdir, f"{key}_faces.mp4"),
                cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (224, 224))
            for _ in range(int(rng.integers(*frames))):
                jitter = np.clip(img224.astype(np.int16)
                                 + rng.integers(-10, 10, img224.shape), 0, 255)
                writer.write(jitter.astype(np.uint8)[:, :, ::-1])
            writer.release()

            tone = 0.3 * np.sin(2 * np.pi * (200 + 60 * ei)
                                * np.arange(SAMPLE_RATE) / SAMPLE_RATE)
            tone = (tone + rng.normal(scale=0.05, size=tone.shape)
                    ).astype(np.float32)
            with wave.open(os.path.join(adir, f"{key}.wav"), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(SAMPLE_RATE)
                f.writeframes((tone * 32767).astype(np.int16).tobytes())


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                       "mmer_e2e_demo"))
    parser.add_argument("--actors", type=int, default=12,
                        help=">= 10 so the 80/10/10 stratified split has "
                             "every class in each fold")
    parser.add_argument("--keep", action="store_true")
    parser.add_argument("--hbm", action="store_true",
                        help="raw-media route: extract straight into the "
                             "trainer (--raw_videos / --raw_audio) instead "
                             "of writing npy artifacts")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a GPU) or cpu")
    args = parser.parse_args(argv)

    from mmer_tpu_torch.preprocess.extract import (extract_audio_folder,
                                                   extract_video_folder)
    from mmer_tpu_torch.train.cli import main as train_main

    root = args.root
    if os.path.isdir(root):
        shutil.rmtree(root)
    print(f"[1/4] generating {args.actors * 6} synthetic clips -> {root}")
    generate_dataset(root, args.actors)

    common = ["--batch_size", "16", "--num_epochs", "40", "--lr", "1e-4",
              "--output_dir", os.path.join(root, "runs"),
              "--device", args.device, "--fused"]
    if args.hbm:
        print("[2-4/4] raw-media route: extract on the device -> fused "
              "train, no npy")
        out = train_main(common + [
            "--raw_videos", os.path.join(root, "videos"),
            "--raw_audio", os.path.join(root, "audio")])
    else:
        print("[2/4] video features (full-size ViViT)")
        extract_video_folder(os.path.join(root, "videos"),
                             os.path.join(root, "video_features"),
                             verbose=False, device=args.device)
        print("[3/4] audio features (Wav2Vec2-large)")
        extract_audio_folder(os.path.join(root, "audio"),
                             os.path.join(root, "audio_features"),
                             verbose=False, device=args.device)
        print("[4/4] fused training on the extracted artifacts")
        out = train_main(common + [
            "--video_feat_dir", os.path.join(root, "video_features"),
            "--audio_feat_dir", os.path.join(root, "audio_features")])

    # Multi-chunk clips exercised: the trainer's max_seq_len follows the
    # dataset's largest T.
    msl = out.hyperparameters["max_seq_len"]
    assert msl >= 3, f"expected multi-chunk clips (T>=2), max_seq_len={msl}"
    best = max((r.get("test_acc", 0.0) for r in out.results), default=0.0)
    ok = best > 80
    print(f"\nE2E RESULT: best test acc {best:.1f}% "
          f"(T up to {msl - 1} chunks/clip; "
          f"{'OK' if ok else 'UNEXPECTEDLY LOW'})")
    if not args.keep:
        shutil.rmtree(root)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
