"""Serve the frontend and the API from one process for a hands-on demo, the
port of ``scripts/demo_frontend.py``.

    python3 -m mmer_tpu_torch.scripts.demo_frontend --device cpu \\
        [--port 8123] [--frames 48] [--full-models]

Starts the port's server (``serve/app.py``) with an ``InferenceEngine`` and
serves a synthetic demo clip at ``/static/demo.mp4``: the packaged face
(``assets/face_300x256.npy``) with seeded jitter, 30 fps, and a PCM tone
track, so that opening

    http://127.0.0.1:<port>/?demo=/static/demo.mp4&subchunk=4&window=2&detect=3

runs the no-build frontend's upload, ``/infer``, overlay, waveform and IG
chart on it.  The engine is tiny (float32 configs that run every code path at
interactive speed on a CPU) unless ``--full-models``.  Writing the clip needs
``cv2`` with an mp4 encoder: where there is none (the GPU machine has no
``cv2``) the demo says so and exits non-zero.  The engine runs on the GPU by
default and raises without one; ``--device cpu`` runs it on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

FACE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "assets", "face_300x256.npy")
TINY_VIVIT = dict(image_size=(32, 32), patch_size=(16, 16), num_frames=4,
                  tubelet_size=2, dim=768, depth=1, heads=2, dim_head=32,
                  mlp_dim=64, compute_dtype="float32")
# hidden_dim stays 1024, the fusion model's audio width.
TINY_WAV = dict(hidden_dim=1024, num_layers=1, num_heads=2, ffn_dim=64,
                conv_dims=(16, 16), conv_strides=(5, 2), conv_kernels=(10, 3),
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                compute_dtype="float32")
TINY_FUSION = dict(max_seq_len=8, fusion_layers=1, compute_dtype="float32")


def make_demo_clip(path: str, frames: int = 48, audio: bool = True) -> None:
    """An mp4 of ``frames`` frames of the packaged face with seeded jitter,
    and by default a 330 Hz tone track (``serve/pcm_mp4``) for the audio leg
    and the frontend's waveform."""
    import cv2

    img = np.load(FACE)                                   # (H, W, 3) RGB
    size = (img.shape[1], img.shape[0])
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, size)
    if not w.isOpened():
        raise RuntimeError("no mp4 encoder available in cv2")
    rng = np.random.default_rng(0)
    for _ in range(frames):
        jitter = img.astype(np.int16) + rng.integers(-8, 8, img.shape)
        w.write(np.clip(jitter, 0, 255).astype(np.uint8)[:, :, ::-1])
    w.release()
    if audio:
        from mmer_tpu_torch.serve.pcm_mp4 import mux_pcm_into_file

        sr = 16000
        t = np.arange(int(frames / 30.0 * sr)) / sr
        wav = (0.4 * np.sin(2 * np.pi * 330 * t)
               * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t))).astype(np.float32)
        mux_pcm_into_file(path, wav, sr)


def build_demo(device, workdir: str, frames: int = 48,
               full_models: bool = False):
    """Writes the demo clip under ``workdir`` and builds the engine; returns
    ``(engine, extra_static)``, ``extra_static`` the route of the clip as
    ``serve`` and ``make_handler`` take it."""
    from mmer_tpu_torch.config import ModelConfig, ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.serve.engine import InferenceEngine

    clip = os.path.join(workdir, "demo.mp4")
    make_demo_clip(clip, frames=frames)
    if full_models:
        engine = InferenceEngine(device)
    else:
        engine = InferenceEngine(device, model_cfg=ModelConfig(**TINY_FUSION),
                                 vivit_cfg=ViViTConfig(**TINY_VIVIT),
                                 wav_cfg=Wav2Vec2Config(**TINY_WAV))
    return engine, {"/static/demo.mp4": (clip, "video/mp4")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--port", type=int, default=8123)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--frames", type=int, default=48)
    parser.add_argument("--full-models", action="store_true",
                        help="the full-size extractors (slow on a CPU)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    from mmer_tpu_torch.scripts.timing import resolve_device

    device = resolve_device(args.device)
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("demo_frontend: writing the demo clip needs cv2 with an mp4 "
              "encoder, which this machine lacks", file=sys.stderr)
        return 1
    from mmer_tpu_torch.serve.app import serve

    workdir = tempfile.mkdtemp(prefix="mmer_demo_")
    engine, extra = build_demo(device, workdir, args.frames, args.full_models)
    print(f"demo clip: {extra['/static/demo.mp4'][0]} ({args.frames} frames)")
    print(f"open: http://{args.host}:{args.port}/"
          "?demo=/static/demo.mp4&subchunk=4&window=2&detect=3", flush=True)
    serve(engine, host=args.host, port=args.port, extra_static=extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
