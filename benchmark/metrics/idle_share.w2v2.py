"""``idle_share.w2v2`` (%): the share of the traced window in which no
kernel, copy or set ran on the device.  Layer: device.  Moves
``audio_s_per_s``."""

from benchmark.trace import Trace


def read(t: Trace):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
