"""``conv_roofline.w2v2`` (%): the least time of the traced window's conv
encoder passes (seven conv → LayerNorm → GELU layers over every forward's
rows x samples: f32 waves read, bf16 frame features written, f32 params)
over the device time of the launches that compute them (the mega route: a
layer-0 launch and one for each later layer).  Layer: kernels
(``ops/conv_pyramid.py`` → ``csrc/conv_encoder.cu``).  Moves
``audio_s_per_s``."""

from benchmark import work
from benchmark.trace import Trace, roofline

FIRST, MAIN = "conv0_ln_gelu_kernel", "conv_ln_gelu_kernel"


def launches(t: Trace) -> dict:
    n = len(t.forwards)
    return {FIRST: n, MAIN: (len(t.config["model"]["conv_dims"]) - 1) * n}


def read(t: Trace):
    m = t.config["model"]
    bound = sum(work.conv_encoder_bound_s(m, f["rows"], f["samples"])
                for f in t.forwards)
    return roofline(t, (FIRST, MAIN), MAIN, launches(t)[MAIN], bound)
