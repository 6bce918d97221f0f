"""``other_ms.w2v2`` (ms/audio-s): device time of every operation of the
traced window that is neither one of the port's hand-written kernels nor a
copy (which ``h2d_ms.w2v2`` counts) over the useful audio seconds: plain
float32 attention, the projections, the positional conv, the LayerNorms,
the casts, the pool.  Layer: model step.  Moves ``audio_s_per_s``."""

from benchmark.trace import Trace

# The port's hand-written kernels (mmer_tpu_torch/csrc/*.cu) by base name.
PORT_KERNELS = frozenset((
    "ffn_kernel", "ffn_reduce_kernel", "attention_kernel", "conv_ln_gelu_kernel",
    "conv0_ln_gelu_kernel", "gemm_ln_gelu_kernel", "gemm0_ln_gelu_kernel",
    "k3_ln_gelu_kernel", "ln_matmul_kernel", "row_quant_kernel",
    "row_quant_kernel_wide", "int8_gemm_kernel", "threefry_kernel"))


def read(t: Trace):
    ops = [o for o in t.ops if o.kind in ("kernel", "set")
           and o.base not in PORT_KERNELS]
    return 1e3 * t.seconds(ops) / t.useful if ops and t.useful else None
