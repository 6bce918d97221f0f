"""``cast_mb.w2v2`` (MB/audio-s): the bytes the traced window's casts of
float32 parameters to the compute dtype read and wrote
(``weights.cast_bytes``, counted by ``mmer_tpu_torch.utils.profiling.cast``
a forward: the conv encoder's weights, the projections, the positional
conv, the FFN weights and biases) over the seconds of audio embedded.
Source: the program's counters.  Layer: model step.  Moves
``audio_s_per_s``."""

from benchmark import program
from benchmark.trace import Trace


def read(t: Trace):
    return program.per_unit(program.counters().get("weights.cast_bytes"), t.useful, 1e-6)
