"""Component throughput of the extraction and serving stages, the port of
``scripts/bench_extract.py``.

On one device, after a warm call, the best of three:

- ViViT chunk embedding: 32 uint8 chunks through ``embed_chunks`` at
  ``device_batch=16`` (the default ViViT-B on its kernel route);
- Wav2Vec2-large audio embedding: 16 clips of 3 s through ``embed_batch``;
- the Haar face detector (host, the native cascade) on a 224² frame, the
  mean of 10 calls;
- the fusion model's inference at B = 256 windows of T = 5 subchunks,
  ``max_seq_len=6``.

Prints the JAX script's four lines, then one JSON line with the same
numbers.

    python3 -m mmer_tpu_torch.scripts.bench_extract               # on the card
    python3 -m mmer_tpu_torch.scripts.bench_extract --device cpu  # full width: slow

Without CUDA it refuses to start unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np


def _timed(fn) -> float:
    """Wall seconds for one call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None, *, vivit_cfg=None, wav_cfg=None,
         model_cfg=None) -> dict:
    """Runs the four legs and returns the JSON line's numbers.  The configs
    default to the package's (ViViT-B, Wav2Vec2-large, ``ModelConfig(
    max_seq_len=6)``)."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda refuses to start without a GPU "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from mmer_tpu_torch.config import ModelConfig, ViViTConfig, Wav2Vec2Config
    from mmer_tpu_torch.models.fusion import init_fusion
    from mmer_tpu_torch.models.jax_init import PRNGKey
    from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder
    from mmer_tpu_torch.preprocess.extract import VideoFeatureExtractor
    from mmer_tpu_torch.preprocess.faces import HaarFaceDetector
    from mmer_tpu_torch.scripts.timing import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"device: {device} ({name})", flush=True)
    out = {"device": name}

    # -- ViViT ----------------------------------------------------------
    vcfg = vivit_cfg or ViViTConfig()
    ex = VideoFeatureExtractor(vcfg, device=device, device_batch=16)
    chunks = (rng.random((32, vcfg.num_frames, *vcfg.image_size, 3))
              * 255).astype(np.uint8)
    ex.embed_chunks(chunks)                    # warm
    best = min(_timed(lambda: ex.embed_chunks(chunks)) for _ in range(3))
    out["vivit_chunks_per_s"] = 32 / best
    out["vivit_frames_per_s"] = 32 * vcfg.num_frames / best
    print(f"vivit embed (uint8, B=16): {32 / best:.1f} chunks/s "
          f"({32 * vcfg.num_frames / best:.0f} frames/s)", flush=True)

    # -- Wav2Vec2 ---------------------------------------------------------
    emb = AudioEmbedder(wav_cfg or Wav2Vec2Config(), device=device)
    waves = [rng.normal(size=(48000,)).astype(np.float32) for _ in range(16)]
    emb.embed_batch(waves)                     # warm
    best = min(_timed(lambda: emb.embed_batch(waves)) for _ in range(3))
    out["w2v2_clips_per_s"] = 16 / best
    print(f"wav2vec2-large embed: {16 / best:.1f} x 3s clips/s", flush=True)

    # -- detector ---------------------------------------------------------
    det = HaarFaceDetector()
    frame = (rng.random((224, 224, 3)) * 255).astype(np.uint8)
    det.detect(frame)
    t0 = time.perf_counter()
    for _ in range(10):
        det.detect(frame)
    out["detector_ms_per_frame"] = (time.perf_counter() - t0) / 10 * 1e3
    print(f"viola-jones 224^2: {out['detector_ms_per_frame']:.0f} ms/frame",
          flush=True)

    # -- fusion inference -------------------------------------------------
    cfg = model_cfg or ModelConfig(max_seq_len=6)
    model = init_fusion(cfg, device=device, key=PRNGKey(0))
    video = torch.from_numpy(rng.normal(size=(256, 5, cfg.video_dim)).astype(
        np.float32)).to(device)
    audio = torch.from_numpy(rng.normal(size=(256, cfg.audio_dim)).astype(
        np.float32)).to(device)
    mask = torch.zeros((256, 5), dtype=torch.bool, device=device)

    @torch.inference_mode()
    def fusion():
        return model(video, audio, mask)[1].cpu()

    fusion()
    best = min(_timed(fusion) for _ in range(3))
    out["fusion_windows_per_s"] = 256 / best
    print(f"fusion inference: {256 / best:.0f} windows/s (B=256)", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
