"""``ffn_roofline.w2v2`` (%): the least time of the traced window's FFN
sublayers (every forward's rows x frames, f32 stream, bf16 weights and
biases, f32 LN params) over the device time of the launches that compute
them.  Layer: kernels (``ops/fused_blocks.py`` → ``csrc/ffn.cu``).  Moves
``audio_s_per_s``."""

from benchmark import work
from benchmark.trace import Trace, roofline

MAIN, NAMES = "ffn_kernel", ("ffn_kernel", "ffn_reduce_kernel")


def launches(t: Trace) -> dict:
    return {MAIN: t.config["model"]["num_layers"] * len(t.forwards)}


def read(t: Trace):
    m = t.config["model"]
    bound = sum(m["num_layers"] * work.ffn_bound_s(
        f["rows"] * f["frames"], m["hidden_dim"], m["ffn_dim"], work.F32, work.BF16)
        for f in t.forwards)
    return roofline(t, NAMES, MAIN, launches(t)[MAIN], bound)
