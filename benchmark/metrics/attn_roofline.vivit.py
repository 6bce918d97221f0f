"""``attn_roofline.vivit`` (%): the least time of the traced window's
attention (``softmax(q kᵀ/√d) v`` over every forward's rows, heads and
tokens, bf16 q, k, v and output; ``4·S²·d`` operations a head) over the
device time of the launches that compute it.  Layer: kernels
(``ops/flash_attention.py`` → ``csrc/attention.cu``).  Moves
``chunks_per_s``."""

from benchmark import work
from benchmark.trace import Trace, roofline

MAIN = "attention_kernel"


def launches(t: Trace) -> dict:
    return {MAIN: t.config["model"]["depth"] * len(t.forwards)}


def read(t: Trace):
    m = t.config["model"]
    bound = sum(m["depth"] * work.attention_bound_s(f["rows"], m["heads"],
                                                    f["tokens"], m["dim_head"])
                for f in t.forwards)
    return roofline(t, (MAIN,), MAIN, launches(t)[MAIN], bound)
