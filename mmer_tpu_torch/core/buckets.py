"""Batch-dimension bucketing, copied from ``mmer_tpu/core/buckets.py``.

PyTorch runs eagerly, so an unbounded family of batch sizes costs it no
compiles; the port keeps the buckets so that its batches, and so its
padding rows, match the JAX package's in the parity tests.
"""

from __future__ import annotations


def batch_bucket(n: int, max_pow2: int = 128) -> int:
    """Round batch size ``n`` up to a bounded shape set: powers of two up
    to ``max_pow2``, then multiples of ``max_pow2``."""
    if n <= 1:
        return 1
    if n >= max_pow2:
        return -(-n // max_pow2) * max_pow2
    return 1 << (n - 1).bit_length()
