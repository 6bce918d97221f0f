"""``ffn_roofline.vivit`` (%): the least time of the traced window's FFN
sublayers (``x + GELU(LN(x) W1ᵀ + b1) W2ᵀ + b2`` over every forward's
rows x tokens, bf16 stream and weights, f32 LN params and biases; the
larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s) over the device
time of the launches that compute them.  Layer: kernels
(``ops/fused_blocks.py`` → ``csrc/ffn.cu``).  Moves ``chunks_per_s``."""

from benchmark import work
from benchmark.trace import Trace, roofline

MAIN, NAMES = "ffn_kernel", ("ffn_kernel", "ffn_reduce_kernel")


def launches(t: Trace) -> dict:
    return {MAIN: t.config["model"]["depth"] * len(t.forwards)}


def read(t: Trace):
    m = t.config["model"]
    bound = sum(m["depth"] * work.ffn_bound_s(f["rows"] * f["tokens"], m["dim"],
                                              m["mlp_dim"], work.BF16, work.F32)
                for f in t.forwards)
    return roofline(t, NAMES, MAIN, launches(t)[MAIN], bound)
