"""``h2d_ms.w2v2`` (ms/audio-s): device time of the host-to-device copies of
the traced window over the seconds of audio its calls returned embeddings
for (padding not counted).  Layer: batching, host (``embed_batch``,
``_embed_padded``: the padded f32 batch and its frame mask).  Moves
``audio_s_per_s``."""

from benchmark.trace import Trace


def read(t: Trace):
    copies = [o for o in t.ops if o.kind == "h2d"]
    return 1e3 * t.seconds(copies) / t.useful if copies and t.useful else None
