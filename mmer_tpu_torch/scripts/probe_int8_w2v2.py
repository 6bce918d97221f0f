"""int8-GEMM Wav2Vec2 against the default embedder, the port of
``scripts/probe_int8_w2v2.py``.

    python3 -m mmer_tpu_torch.scripts.probe_int8_w2v2 [--device cuda]

Wav2Vec2-large with the JAX package's seeded weights on distinct seeded
batches of 64 clips x 64,000 samples (the 4 s bucket, no frame padded), the
pooled forward of ``AudioEmbedder.embed_rows`` (encoder, masked mean pool,
L2 norm) in two legs:

1. ``bf16``: the default ``AudioEmbedder`` (the conv encoder's whole-pyramid
   kernel, plain attention, the FFN kernel);
2. ``int8``: ``quant_w2v2_embed`` on the same weights, the int8 products of
   ``csrc/qdot.cu`` and the same conv kernel (``mega``, JAX's
   ``use_pyramid=True``), the same pool and norm.

Each leg prints ms, clips/s, TOP/s and its speedup over ``bf16``; the
``int8`` leg its cosine and rel-L2 against ``bf16`` a clip and its largest
rel-L2 a clip against the int8 forward's plain route (``use_kernels=False``)
on the first batch.  Timing: CUDA events after a warm-up pass, cycling over
the batches (``scripts/timing.py``).  ``--tiny`` rehearses the control flow
on the CPU on a small config with the plain versions (host clock; no device
numbers).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from mmer_tpu_torch.config import Wav2Vec2Config
from mmer_tpu_torch.models.wav2vec2 import AudioEmbedder, feat_extract_output_length
from mmer_tpu_torch.models.wav2vec2_quant import quant_w2v2_embed, quantize_w2v2_params
from mmer_tpu_torch.scripts.probe_int8 import parse_args
from mmer_tpu_torch.scripts.probe_int8_vivit import run_legs
from mmer_tpu_torch.scripts.probe_w2v2_flash import model_flops
from mmer_tpu_torch.scripts.profile_w2v2 import TINY
from mmer_tpu_torch.scripts.timing import INPUTS

B, SAMPLES = 64, 64000
TINY_B = 4


def main(argv=None) -> list:
    args = parse_args(argv, __doc__.split("\n\n")[0])
    device = args.device
    cfg = Wav2Vec2Config(**TINY) if args.tiny else Wav2Vec2Config()
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    b, n_inputs = (TINY_B, 1) if args.tiny else (B, INPUTS)
    n_pad = -(-SAMPLES // cfg.sample_rate) * cfg.sample_rate
    t = feat_extract_output_length(cfg, n_pad)
    mask = (torch.arange(t) >= feat_extract_output_length(cfg, SAMPLES)
            ).expand(b, t).contiguous().to(device)
    rng = np.random.default_rng(0)
    waves = [torch.from_numpy(np.pad(rng.normal(size=(b, SAMPLES)).astype(np.float32),
                                     ((0, 0), (0, n_pad - SAMPLES)))).to(device)
             for _ in range(n_inputs)]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} ({name}) B={b} frames={t} {cfg.compute_dtype}, "
          f"{n_inputs} inputs", flush=True)
    emb = AudioEmbedder(cfg, device=device)
    qp = quantize_w2v2_params(emb.model)
    legs = (("bf16", lambda w: emb.embed_rows(w, mask)),
            ("int8", lambda w: quant_w2v2_embed(qp, emb.model, w, mask)))
    with torch.inference_mode():
        plain = quant_w2v2_embed(qp, emb.model, waves[0], mask, use_kernels=False)
        return run_legs(legs, waves, plain, model_flops(cfg, t, b, n_pad), b,
                        "clips", device, name)


if __name__ == "__main__":
    main(sys.argv[1:])
