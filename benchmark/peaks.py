"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit) and the least time a piece of work can take.

Copied from ``mmer_tpu_torch/scripts/timing.py`` (``PEAK_FLOPS``,
``PEAK_BYTES``, ``bound_ms``) so that the yardstick stays put when the port
changes.
"""

from __future__ import annotations

# Dense bf16 tensor-core operations a second.
PEAK_FLOPS = 989e12
# HBM3 bytes a second.
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for ``flops`` operations and
    ``nbytes`` bytes: the larger of the two at their peaks.  Count each input
    byte read once and each output byte written once."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
