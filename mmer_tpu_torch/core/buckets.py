"""Batch and frame-size bucketing, copied from ``mmer_tpu/core/buckets.py``.

PyTorch runs eagerly, so an unbounded family of batch sizes or frame sizes
costs it no compiles; the port keeps the buckets so that its batches, its
padding rows and its padded frames match the JAX package's in the parity
tests.
"""

from __future__ import annotations


# Per-axis frame-size ladder for serving uploads: every frame is padded up to
# the next rung by edge replication (in-bounds crops keep their bits: the
# bilinear weights normalise over equal replicated pixels); frames beyond the
# top rung are downscaled to fit first, with their boxes.
RESOLUTION_LADDER = (160, 240, 320, 480, 640, 720, 960, 1280, 1920)


def resolution_bucket(h: int, w: int) -> tuple:
    """((ch, cw), scale): the canonical padded frame size for an upload
    frame of (h, w), and the downscale factor to apply first (1.0 for
    anything within the ladder)."""
    top = RESOLUTION_LADDER[-1]
    scale = min(1.0, top / h, top / w)
    if scale < 1.0:
        h, w = int(round(h * scale)), int(round(w * scale))
        h, w = min(h, top), min(w, top)
    ch = next(r for r in RESOLUTION_LADDER if r >= h)
    cw = next(r for r in RESOLUTION_LADDER if r >= w)
    return (ch, cw), scale


def batch_bucket(n: int, max_pow2: int = 128) -> int:
    """Round batch size ``n`` up to a bounded shape set: powers of two up
    to ``max_pow2``, then multiples of ``max_pow2``."""
    if n <= 1:
        return 1
    if n >= max_pow2:
        return -(-n // max_pow2) * max_pow2
    return 1 << (n - 1).bit_length()
