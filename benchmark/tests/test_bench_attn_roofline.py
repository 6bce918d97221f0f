"""``attn_roofline.w2v2``: its bound reproduces plain attention's work at
both Wav2Vec2 cells' shapes, counted by hand, and it reads nothing where the
program launches no plain-attention kernel (the programs before it)."""

import pytest

from benchmark import spec
from benchmark.trace import DeviceOp, Trace

W2V2 = spec.cell(spec.load(), "w2v2-large.long").config["model"]
READER = spec.module("metrics", "attn_roofline.w2v2")


def _trace(ops, forwards) -> Trace:
    return Trace(window_s=1.0, busy_s=0.5, ops=ops, gaps=[], config={"model": W2V2},
                 useful=10.0, forwards=forwards)


@pytest.mark.parametrize("frames,flops,nbytes", [
    # 4 x 64 rows x 16 heads x 499^2 x 64 = 65.27 GFLOP (0.0660 ms at 989
    # TFLOP/s); q, k, v and the output, 64 x 499 x 1024 bf16 each, and the
    # mask: 261.67 MB (0.0781 ms at 3.35 TB/s), which bounds it.
    (499, 4 * 64 * 16 * 499 * 499 * 64, 4 * 64 * 499 * 1024 * 2 + 64 * 499),
    # 64 x 249: 16.25 GFLOP (0.0164 ms), 130.57 MB (0.0390 ms).
    (249, 4 * 64 * 16 * 249 * 249 * 64, 4 * 64 * 249 * 1024 * 2 + 64 * 249),
])
def test_bound_is_the_layers_work_at_the_cells_shapes(frames, flops, nbytes):
    assert READER.layer_bound_s(W2V2, 64, frames) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert READER.layer_bound_s(W2V2, 64, frames) == pytest.approx(
        nbytes / 3.35e12)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::plain_attention_kernel(__nv_bfloat16 const*, int)", 25.0),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 9>(int)", None),
])
def test_reads_one_launch_a_layer_and_nothing_without_the_kernel(name, want):
    forwards = [{"rows": 64, "frames": 499, "samples": 160000}] * 2
    layers = W2V2["num_layers"]
    bound_us = READER.layer_bound_s(W2V2, 64, 499) * 1e6
    ops = [DeviceOp(name, i * 500.0, 4 * bound_us, "kernel") for i in range(2 * layers)]
    t = _trace(ops, forwards)
    assert READER.launches(t) == {"plain_attention_kernel": 2 * layers}
    got = READER.read(t)
    assert got == (None if want is None else pytest.approx(want))
