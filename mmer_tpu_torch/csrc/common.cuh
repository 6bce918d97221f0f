// Shared helpers for the hand-written Hopper kernels of mmer_tpu_torch.
//
// Every kernel library exposes a plain C interface (bound with ctypes, no
// PyTorch headers): each entry point launches on the stream it is given and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  mmer_error_string turns such a code into CUDA's own message.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace mmer {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round-to-nearest-even through bfloat16 and back: the rounding points the
// JAX modules take with ``.astype(jnp.bfloat16)``.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Exact-erf GELU in float32 (jax.nn.gelu(approximate=False), torch F.gelu).
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one row of D values by one warp, in f32 with flax semantics
// (eps 1e-6, var = max(0, E[x^2] - E[x]^2)), rounded to bf16 into ``dst``:
// the prologue shared by the fused FFN and the fused LN-matmul kernels.
template <int D, typename XT>
__device__ __forceinline__ void ln_row_bf16(const XT* xr, const float* ln_w,
                                            const float* ln_b, bf16* dst, int lane) {
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    float v = to_f32(xr[c]);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / D;
  const float var = fmaxf(ss / D - mean * mean, 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
  for (int c = lane; c < D; c += 32) {
    float v = (to_f32(xr[c]) - mean) * rstd;
    dst[c] = __float2bfloat16_rn(v * ln_w[c] + ln_b[c]);
  }
}

// LayerNorm (ln_row_bf16) of the ``rows`` token rows that start at row ``n0``
// of x (n_tok, D) into a bf16 tile of row stride ``ld``, one warp per row;
// rows at or past n_tok are never read and become zero rows.
template <int D, typename XT>
__device__ __forceinline__ void ln_tile_bf16(const XT* x, const float* ln_w,
                                             const float* ln_b, bf16* tile, int ld,
                                             long n0, int n_tok, int rows, int warp,
                                             int nwarp, int lane) {
  for (int r = warp; r < rows; r += nwarp) {
    const long n = n0 + r;
    if (n >= n_tok) {
      for (int c = lane; c < D; c += 32) tile[r * ld + c] = __float2bfloat16_rn(0.f);
      continue;
    }
    ln_row_bf16<D>(x + n * D, ln_w, ln_b, tile + r * ld, lane);
  }
}

// The conv feature encoder's epilogue on one output frame, by one warp: the
// f32 conv sums ``yrow`` (C channels) are rounded to bf16, the bias is added
// in bf16, LayerNorm runs in f32 (flax: eps 1e-6, var = max(0, E[x^2] -
// E[x]^2)) and is rounded to bf16, exact-erf GELU runs in f32 and is rounded
// to bf16 into ``dst`` -- the rounding points of the Pallas ``_epilogue``
// (mmer_tpu/ops/conv_pyramid.py).  Each lane holds C/32 channels.
template <int C>
__device__ __forceinline__ void bias_ln_gelu_row(const float* yrow, const float* cb,
                                                 const float* ln_w, const float* ln_b,
                                                 bf16* dst, int lane) {
  float y[C / 32];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const int c = lane + 32 * i;
    y[i] = round_bf16(round_bf16(yrow[c]) + round_bf16(cb[c]));
    s += y[i];
    ss += y[i] * y[i];
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / C;
  const float var = fmaxf(ss / C - mean * mean, 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const int c = lane + 32 * i;
    const float ln = round_bf16((y[i] - mean) * rstd * ln_w[c] + ln_b[c]);
    dst[c] = __float2bfloat16_rn(gelu_erf(ln));
  }
}

}  // namespace mmer

#define MMER_EXPORT extern "C" __attribute__((visibility("default")))

MMER_EXPORT const char* mmer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
