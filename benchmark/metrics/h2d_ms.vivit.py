"""``h2d_ms.vivit`` (ms/chunk): device time of the host-to-device copies of
the traced window over the useful chunks its calls returned (padding rows
not counted).  Layer: batching, host (``embed_chunks``: the pageable uint8
upload of each device batch).  Moves ``chunks_per_s``."""

from benchmark.trace import Trace


def read(t: Trace):
    copies = [o for o in t.ops if o.kind == "h2d"]
    return 1e3 * t.seconds(copies) / t.useful if copies and t.useful else None
