// Shared helpers for the hand-written Hopper kernels of mmer_tpu_torch.
//
// Every kernel library exposes a plain C interface (bound with ctypes, no
// PyTorch headers): each entry point launches on the stream it is given and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  mmer_error_string turns such a code into CUDA's own message.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// v[i] for a lane-dependent i without local memory.
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Two bf16 values as one word, ``lo`` in the low half; the f32 values back.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Eight consecutive values of a row as floats, by 16-byte loads.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// LayerNorm of the ``rows`` token rows that start at row ``n0`` of x (n_tok, D),
// one warp a row, into the shared-memory layout wgmma reads (wgmma.cuh): the
// (rows, D) tile is D/64 tiles of (rows x 64 bf16), each row 128 bytes with its
// 16-byte chunks in the 128-byte swizzle; ``tile`` is 1024-byte aligned.  f32
// statistics with flax semantics (eps 1e-6, var = max(0, E[x^2] - E[x]^2)),
// one rounding to bf16: the prologue of the fused FFN and LN-matmul kernels.
// A lane owns chunks of eight consecutive columns (chunk lane + 32 i), loaded
// and stored 16 bytes at a time, and sums them in (i, column) order before
// warp_sum's xor butterfly.  Rows at or past n_tok are zero rows.
template <int D, typename XT>
__device__ __forceinline__ void ln_tile_bf16_sw128(const XT* x, const float* ln_w,
                                                   const float* ln_b, unsigned char* tile,
                                                   long n0, int n_tok, int rows, int warp,
                                                   int nwarp, int lane) {
  constexpr int NCH = D / 256;        // chunks of 8 columns a lane
  static_assert(D % 256 == 0, "a warp covers 256 columns a pass");
  for (int r = warp; r < rows; r += nwarp) {
    const long n = n0 + r;
    float v[NCH][8];
    float s = 0.f, ss = 0.f;
    if (n < n_tok) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        load8(x + n * D + (lane + 32 * i) * 8, v[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[i][e];
          ss += v[i][e] * v[i][e];
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / D;
    const float var = fmaxf(ss / D - mean * mean, 0.f);
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = (lane + 32 * i) * 8;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (n < n_tok) {
        float w[8], b[8];
        load8(ln_w + c, w);
        load8(ln_b + c, b);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = __floats2bfloat162_rn((v[i][2 * e] - mean) * rstd * w[2 * e] + b[2 * e],
                                       (v[i][2 * e + 1] - mean) * rstd * w[2 * e + 1] +
                                           b[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(tile + size_t(c >> 6) * rows * 128 + r * 128 +
                                ((((c >> 3) & 7) ^ (r & 7)) << 4)) = packed;
    }
  }
}

}  // namespace mmer

#define MMER_EXPORT extern "C" __attribute__((visibility("default")))

MMER_EXPORT const char* mmer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
