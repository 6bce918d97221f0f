"""The program's own spans and counters, for the per-layer readers whose
source is ``program_span`` or ``program_counter``.

The port totals them in ``mmer_tpu_torch.utils.profiling.counters`` only
while a ``torch.profiler`` records: a span's seconds under its name
(``mmer.w2v2.pad``), a counter under its own (``w2v2.frames_useful``,
``weights.cast_bytes``).  A run of the benchmark records in its traced
window alone (the call traced and dropped before it is the profiler's
warm-up step, which records nothing), so in a traced run the totals are the
window's.  A program without the tracer has no ``counters``: every reader
then finds nothing and returns None.
"""

from __future__ import annotations


def counters() -> dict:
    """A copy of the program's totals; empty where the program has none."""
    try:
        from mmer_tpu_torch.utils import profiling
    except ImportError:
        return {}
    return dict(getattr(profiling, "counters", {}))


def per_unit(total, useful: float, scale: float):
    """``scale`` x ``total`` over the window's useful work; None where the
    program counted nothing or no work was useful."""
    return scale * total / useful if total is not None and useful else None
