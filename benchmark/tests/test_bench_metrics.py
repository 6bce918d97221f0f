"""The yardstick's arithmetic: the operation and byte counts reproduce the
bounds of PERF.md §6 from shapes, and the trace readers reduce a trace as
their docstrings say."""

import pytest

from benchmark import spec, work
from benchmark.trace import DeviceOp, Trace, _label, base_name, kind_of, roofline

VIVIT = spec.cell(spec.load(), "vivit-b.extract").config["model"]
W2V2 = spec.cell(spec.load(), "w2v2-large.extract").config["model"]


def test_bounds_of_the_kernel_table():
    assert work.ffn_bound_s(8 * 1569, 768, 3072, work.BF16, work.F32) * 1e3 == \
        pytest.approx(0.1198, abs=5e-5)
    assert work.attention_bound_s(8, 12, 1569, 64) * 1e3 == pytest.approx(0.0612, abs=5e-5)
    assert work.conv_encoder_bound_s(W2V2, 64, 80000) * 1e3 == \
        pytest.approx(1.5877, abs=5e-5)


def test_model_operations():
    assert work.vivit_tokens(VIVIT) == 1569
    assert work.vivit_chunk_flops(VIVIT) / 1e9 == pytest.approx(364.674, abs=1e-3)
    assert work.w2v2_frames(W2V2, 80000) == 249
    assert work.w2v2_frames(W2V2, 160000) == 499
    # A piece's operations count its own frames, not a padded length.
    assert work.w2v2_piece_flops(W2V2, 48000) < work.w2v2_piece_flops(W2V2, 80000)


def test_kernel_names_and_kinds():
    assert base_name("void ffn_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)") == "ffn_kernel"
    assert base_name("void (anonymous namespace)::attention_kernel<false, 1>(...)") \
        == "attention_kernel"
    assert base_name("conv0_ln_gelu_kernel(float const*)") == "conv0_ln_gelu_kernel"
    assert kind_of("Memcpy HtoD (Pageable -> Device)") == "h2d"
    assert kind_of("Memcpy DtoH (Device -> Pageable)") == "d2h"
    assert kind_of("Memset (Device)") == "set"
    assert kind_of("ampere_bf16_s16816gemm") == "kernel"


def _trace(ops) -> Trace:
    return Trace(window_s=1.0, busy_s=0.5, ops=ops, gaps=[], config={"model": VIVIT},
                 useful=10.0, flops=989e12 * 0.25)


def test_roofline_scales_dropped_launches_and_reports_none_without_any():
    ops = [DeviceOp("void ffn_kernel<x>()", i * 10.0, 4.0, "kernel") for i in range(3)]
    t = _trace(ops)
    assert roofline(t, ("ffn_kernel",), "ffn_kernel", 3, 6e-6) == pytest.approx(50.0)
    # One of four launches dropped: the three seen stand for four.
    assert roofline(t, ("ffn_kernel",), "ffn_kernel", 4, 8e-6) == pytest.approx(50.0)
    assert roofline(_trace([]), ("ffn_kernel",), "ffn_kernel", 4, 8e-6) is None


def test_readers():
    ops = [DeviceOp("Memcpy HtoD (Pageable -> Device)", 0.0, 2000.0, "h2d"),
           DeviceOp("void ffn_kernel<x>()", 3000.0, 1000.0, "kernel"),
           DeviceOp("ampere_bf16_gemm", 5000.0, 3000.0, "kernel"),
           DeviceOp("Memset (Device)", 9000.0, 1000.0, "set")]
    t = _trace(ops)
    read = {m: spec.module("metrics", m).read(t)
            for m in ("h2d_ms.vivit", "other_ms.vivit", "idle_share.vivit", "mfu.vivit")}
    assert read["h2d_ms.vivit"] == pytest.approx(0.2)       # 2 ms over 10 chunks
    assert read["other_ms.vivit"] == pytest.approx(0.4)     # gemm + memset
    assert read["idle_share.vivit"] == pytest.approx(50.0)
    assert read["mfu.vivit"] == pytest.approx(25.0)
    assert spec.module("metrics", "h2d_ms.vivit").read(_trace(ops[1:])) is None


def test_gap_is_named_by_what_the_host_did_halfway_through_it():
    spans = [("bench.call", 0.0, 100.0)]
    host = [("cudaMemcpyAsync", 0.0, 10.0), ("aten::copy_", 40.0, 60.0),
            ("cudaLaunchKernel", 45.0, 55.0)]
    assert _label(50.0, spans, host) == "call/cudaLaunchKernel"
    assert _label(20.0, spans, host) == "call"               # numpy or Python
    assert _label(150.0, spans, host) == "between calls"
