"""Dataset-prep CLI, the port of ``mmer_tpu/preprocess/prep.py``: the
reference's six prep scripts as one tool.

Reference scripts → subcommands:
- ``cremad_extract_bboxes.py`` / ``ravdess_extract_bboxes.py`` → ``bboxes``
  (flat CREMA-D folders and RAVDESS actor subfolders alike);
- ``cremad_bbox_converter.py`` / ``ravdess_bbox_converter.py`` → ``faces``;
- ``cremad_video_to_audio_converter.py`` / ``ravdess_…`` → ``audio``.

Usage:
    python3 -m mmer_tpu_torch.preprocess.prep bboxes --input VIDEOS --output extracted_bboxes
    python3 -m mmer_tpu_torch.preprocess.prep faces  --videos VIDEOS --bboxes extracted_bboxes --output extracted_faces_videos
    python3 -m mmer_tpu_torch.preprocess.prep audio  --input VIDEOS --output extracted_audio

``bboxes`` runs the port's cascade and tracker on the host; ``faces`` crops
on ``--device`` (the GPU unless ``--device cpu``; it fails without CUDA);
``audio`` writes mp3 through ffmpeg when there is one, else WAV from the
containers' PCM tracks.  Reading and writing containers needs ``cv2``.
``--detector yolo`` is refused: the port has no YOLO detector (it needs
ultralytics and a weights download).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def cmd_bboxes(args) -> int:
    from mmer_tpu_torch.preprocess.faces import (HaarFaceDetector,
                                                 process_folder_bboxes)

    if args.detector == "yolo":
        print("prep bboxes: --detector yolo is not available in the PyTorch "
              "port (it needs ultralytics and downloaded YOLO weights); use "
              "--detector haar", file=sys.stderr)
        return 2
    n = process_folder_bboxes(args.input, args.output, HaarFaceDetector(),
                              conf_threshold=args.conf)
    print(f"Finished! Processed {n} video files.")
    return 0


def cmd_faces(args) -> int:
    from mmer_tpu_torch.preprocess.faces import convert_folder_faces

    n = convert_folder_faces(args.videos, args.bboxes, args.output,
                             size=(args.size, args.size), device=args.device)
    print(f"Finished! Wrote {n} face videos.")
    return 0


def cmd_audio(args) -> int:
    from mmer_tpu_torch.preprocess.audio import (convert_video_to_audio,
                                                 extract_audio_to_wav,
                                                 ffmpeg_available)
    from mmer_tpu_torch.preprocess.video import iter_video_files

    use_ffmpeg = ffmpeg_available()
    if not use_ffmpeg:
        # Without ffmpeg: WAV from the containers' PCM tracks; a video whose
        # audio is compressed fails on its own below.
        print("ffmpeg not available — writing WAV from decodable "
              "(PCM) audio tracks instead of mp3", file=sys.stderr)
    os.makedirs(args.output, exist_ok=True)
    count = failed = 0
    for video in iter_video_files(args.input):
        stem = os.path.splitext(os.path.basename(video))[0]
        if use_ffmpeg:
            out = os.path.join(args.output, f"{stem}.mp3")
            ok = convert_video_to_audio(video, out, bitrate=args.bitrate)
        else:
            out = os.path.join(args.output, f"{stem}.wav")
            ok = extract_audio_to_wav(video, out)
        if ok:
            count += 1
            print(f"[{count}] {out}", flush=True)
        else:
            failed += 1
            print(f"Error processing {video}", file=sys.stderr)
    print(f"Finished! Converted {count} videos.")
    return 0 if count or not failed else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("bboxes", help="face detection → bbox txt artifacts")
    pb.add_argument("--input", required=True)
    pb.add_argument("--output", required=True)
    pb.add_argument("--conf", type=float, default=0.5)
    pb.add_argument("--detector", choices=["haar", "yolo"], default="haar",
                    help="haar (the port's cascade); yolo is refused")
    pb.set_defaults(fn=cmd_bboxes)

    pf = sub.add_parser("faces", help="bbox txt → cropped face videos")
    pf.add_argument("--videos", required=True)
    pf.add_argument("--bboxes", required=True)
    pf.add_argument("--output", required=True)
    pf.add_argument("--size", type=int, default=224)
    pf.add_argument("--device", default="cuda",
                    help="where the crops run: cuda (default; fails without "
                         "a GPU) or cpu")
    pf.set_defaults(fn=cmd_faces)

    pa = sub.add_parser("audio", help="video → mp3 audio tracks")
    pa.add_argument("--input", required=True)
    pa.add_argument("--output", required=True)
    pa.add_argument("--bitrate", default="320k")
    pa.set_defaults(fn=cmd_audio)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
