"""``useful_share.w2v2`` (%): the frames of the real pieces among the
frames the encoder ran in the traced window, as the program counts them in
``AudioEmbedder._embed_padded`` (``w2v2.frames_useful`` over
``w2v2.frames_computed``: every row of the ``batch_bucket`` batch times the
padded frames).  The rest is padding: the 1 s length bucket and the
repeated rows.  Source: the program's counters.  Layer: batching, host.
Moves ``audio_s_per_s``."""

from benchmark import program
from benchmark.trace import Trace


def read(t: Trace):
    seen = program.counters()
    computed = seen.get("w2v2.frames_computed")
    return 100.0 * seen.get("w2v2.frames_useful", 0) / computed if computed else None
