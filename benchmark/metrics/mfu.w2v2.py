"""``mfu.w2v2`` (%): the model operations the traced window's useful audio
needs (``work.w2v2_piece_flops`` of every piece at its own length, attention
over its own frames; padding not counted) over the window's seconds and the
card's 989 TFLOP/s.  Layer: model step (``models/wav2vec2.py``).  Moves
``audio_s_per_s``."""

from benchmark.peaks import PEAK_FLOPS
from benchmark.trace import Trace


def read(t: Trace):
    return 100.0 * t.flops / (t.window_s * PEAK_FLOPS) if t.flops else None
