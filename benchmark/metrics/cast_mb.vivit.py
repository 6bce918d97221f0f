"""``cast_mb.vivit`` (MB/chunk): the bytes the traced window's casts of
float32 parameters to the compute dtype read and wrote
(``weights.cast_bytes``, counted by ``mmer_tpu_torch.utils.profiling.cast``
a forward: the projections, the FFN weights, the class token and positional
table) over the useful chunks.  Source: the program's counters.  Layer:
model step.  Moves ``chunks_per_s``."""

from benchmark import program
from benchmark.trace import Trace


def read(t: Trace):
    return program.per_unit(program.counters().get("weights.cast_bytes"), t.useful, 1e-6)
