"""Wav2Vec2 q/k/v projection A/B: three projections against one product
over their concatenated weights, the port of ``scripts/probe_w2v2_qkv.py``.

    python3 -m mmer_tpu_torch.scripts.probe_w2v2_qkv [--device cuda]

The full ``Wav2Vec2Encoder`` at the extraction shape (B = 64 x 64,000
samples) with the JAX package's seeded weights, the conv encoder and FFN
kernels on and plain attention (the default route: on the card the
plain-attention kernel, which reads the fused product's q, k and v slices in
place), under the frame mask of
``probe_w2v2_flash``: ``use_fused_qkv=False`` (the default) against
``use_fused_qkv=True``, which concatenates the (d, 3d) weight on every call
as the JAX layer does.  Each variant prints ms and clips/s; then the max
|Δ| over the sampled rows ``[:, :4, :8]`` and the largest relative L2
distance of a clip's output.  ``--device cpu --tiny`` rehearses the control
flow on a small config with the plain versions (host clock).
"""

from __future__ import annotations

import sys

from mmer_tpu_torch.scripts.probe_w2v2_flash import encoder_ab, parse_args


def main(argv=None) -> list:
    args = parse_args(argv, __doc__.split("\n\n")[0])
    return encoder_ab(args, [
        ("separate-qkv", dict(use_flash_attn=False, use_fused_qkv=False)),
        ("fused-qkv", dict(use_flash_attn=False, use_fused_qkv=True))])


if __name__ == "__main__":
    main(sys.argv[1:])
