"""``posconv_roofline.w2v2``: its bound reproduces the positional conv's
operations at the long cell's shape, and it reads nothing where the program
launches no positional-conv kernel (the programs before it)."""

import pytest

from benchmark import spec
from benchmark.trace import DeviceOp, Trace

W2V2 = spec.cell(spec.load(), "w2v2-large.long").config["model"]
READER = spec.module("metrics", "posconv_roofline.w2v2")


def _trace(ops, forwards) -> Trace:
    return Trace(window_s=1.0, busy_s=0.5, ops=ops, gaps=[], config={"model": W2V2},
                 useful=10.0, forwards=forwards)


def test_bound_is_the_conv_operations_at_the_long_cells_shape():
    # 2 x 64 x 499 x 1024 x 64 x 128 = 535.8 GFLOP at 989 TFLOP/s.
    assert READER.sublayer_bound_s(W2V2, 64, 499) * 1e3 == pytest.approx(0.5418, abs=5e-5)
    # One row of 65 frames is bound by its bytes: the 16.8 MB of weights.
    small = READER.sublayer_bound_s(W2V2, 1, 65)
    assert small == pytest.approx((2 * 65 * 1024 * 4 + 65 + 1024 * 64 * 128 * 2 + 2048)
                                  / 3.35e12)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::pos_conv_gelu_kernel<128>(float const*, int)", 50.0),
    ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 128>(int)", None),
])
def test_reads_one_launch_a_forward_and_nothing_without_the_kernel(name, want):
    forwards = [{"rows": 64, "frames": 499, "samples": 160000}] * 2
    bound_us = 2 * READER.sublayer_bound_s(W2V2, 64, 499) * 1e6
    ops = [DeviceOp(name, i * 5000.0, bound_us, "kernel") for i in range(2)]
    t = _trace(ops, forwards)
    assert READER.launches(t) == {"pos_conv_gelu_kernel": 2}
    got = READER.read(t)
    assert got == (None if want is None else pytest.approx(want))
