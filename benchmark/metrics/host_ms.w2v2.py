"""``host_ms.w2v2`` (ms/audio-s): the host's own seconds in
``AudioEmbedder.embed_batch`` over the seconds of audio the traced window
embedded: the spans ``mmer.w2v2.normalise`` (per-clip zero mean, unit
variance, the 10 s split), ``mmer.w2v2.pad`` (bucket fill, frame lengths and
mask, ``batch_bucket`` rows) and ``mmer.w2v2.merge`` (piece means, per-clip
norm), summed.  Source: the program's spans.  Layer: batching, host.  Moves
``audio_s_per_s``."""

from benchmark import program
from benchmark.trace import Trace

STAGES = ("mmer.w2v2.normalise", "mmer.w2v2.pad", "mmer.w2v2.merge")


def read(t: Trace):
    seen = program.counters()
    if not any(s in seen for s in STAGES):
        return None
    return program.per_unit(sum(seen.get(s, 0.0) for s in STAGES), t.useful, 1e3)
