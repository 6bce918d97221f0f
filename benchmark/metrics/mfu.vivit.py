"""``mfu.vivit`` (%): the model operations the traced window's useful chunks
need (``work.vivit_chunk_flops``: 364.7 GFLOP a ViViT-B chunk, padding rows
not counted) over the window's seconds and the card's 989 TFLOP/s.  Layer:
model step (``models/vivit.py``).  Moves ``chunks_per_s``."""

from benchmark.peaks import PEAK_FLOPS
from benchmark.trace import Trace


def read(t: Trace):
    return 100.0 * t.flops / (t.window_s * PEAK_FLOPS) if t.flops else None
