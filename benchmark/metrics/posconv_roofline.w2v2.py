"""``posconv_roofline.w2v2`` (%): the least time of the traced window's
positional-conv sublayers (every forward's rows x frames: the grouped conv of
``num_conv_pos_embeddings`` taps in ``num_conv_pos_embedding_groups`` groups,
2 operations a multiply-add; the f32 stream read and written, the frame
mask, the bf16 weights and bias) over the device time of the launches that
compute them, one a forward.  Layer: kernels (``ops/pos_conv.py`` →
``csrc/pos_conv.cu``).  Moves ``audio_s_per_s``.  A program without the
kernel launches none, and the metric is left out."""

from benchmark.peaks import bound_s
from benchmark.trace import Trace, roofline

MAIN = "pos_conv_gelu_kernel"
F32, BF16, MASK = 4, 2, 1


def sublayer_bound_s(m: dict, rows: int, frames: int) -> float:
    """One positional-conv sublayer over ``rows`` x ``frames``: the conv's
    operations, and each input byte read once and each output byte written
    once."""
    d, taps = m["hidden_dim"], m["num_conv_pos_embeddings"]
    width = d // m["num_conv_pos_embedding_groups"]
    flops = 2.0 * rows * frames * d * width * taps
    nbytes = (2 * rows * frames * d * F32 + rows * frames * MASK
              + d * width * taps * BF16 + d * BF16)
    return bound_s(flops, nbytes)


def launches(t: Trace) -> dict:
    return {MAIN: len(t.forwards)}


def read(t: Trace):
    m = t.config["model"]
    bound = sum(sublayer_bound_s(m, f["rows"], f["frames"]) for f in t.forwards)
    return roofline(t, (MAIN,), MAIN, launches(t)[MAIN], bound)
