"""``attn_roofline.w2v2`` (%): the least time of the traced window's plain
attention (every forward's rows x frames, each layer: ``softmax(q kᵀ/√d) v``
over ``num_heads`` heads of ``hidden_dim / num_heads``, ``4·T²·d``
operations a head; q, k, v bf16 and the frame mask read once, the output
written once in bf16) over the device time of the launches that compute
it, one a layer.  Layer: kernels (``ops/plain_attention.py`` →
``csrc/plain_attention.cu``).  Moves ``audio_s_per_s``.  A program
without the kernel launches none, and the metric is left out."""

from benchmark.peaks import bound_s
from benchmark.trace import Trace, roofline

MAIN = "plain_attention_kernel"
BF16, MASK = 2, 1


def layer_bound_s(m: dict, rows: int, frames: int) -> float:
    """One layer's attention over ``rows`` x ``frames``: its two products'
    operations, and each input byte read once and each output byte written
    once."""
    d = m["hidden_dim"]
    flops = 4.0 * rows * frames * frames * d
    nbytes = 4 * rows * frames * d * BF16 + rows * frames * MASK
    return bound_s(flops, nbytes)


def launches(t: Trace) -> dict:
    return {MAIN: t.config["model"]["num_layers"] * len(t.forwards)}


def read(t: Trace):
    m = t.config["model"]
    bound = sum(m["num_layers"] * layer_bound_s(m, f["rows"], f["frames"])
                for f in t.forwards)
    return roofline(t, (MAIN,), MAIN, launches(t)[MAIN], bound)
