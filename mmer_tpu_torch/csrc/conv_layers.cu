// The per-layer route of the Wav2Vec2 feature encoder: each layer is rows
// times a (K, 512) weight, + bias, LayerNorm over the 512 channels, exact-erf
// GELU, bf16 out.
//
// Replaces the Pallas kernels mmer_tpu/ops/conv_pyramid.py:_gemm_kernel (:91,
// reached from _call_gemm: layer-0 patches, K = 16, or a kernel-2 stride-2
// conv on the stride-merged view, K = 1024) and :_k3_kernel (:97, reached from
// _call_k3: a kernel-3 stride-2 conv on the merged view, output row t =
// xm[t] . [W0;W1] + xm[t+1, :C] . W2).  Numerics are those of the Pallas
// _epilogue: f32 sums rounded to bf16, bias added in bf16, LayerNorm in f32
// rounded to bf16, GELU in f32 rounded to bf16.
//
// This is a second formulation of the same conv stack as conv_encoder.cu,
// independent of it: explicit layer-0 patches built by the caller, the
// (B, T, C) activation viewed as (B, T/2, 2C) merged rows, the weight split
// into [W0;W1] and W2 in the (K, C_out) layout (conv_encoder.cu reads one
// (C_out, k*C_in) matrix and im2col rows of the unmerged activation).  The
// two routes must agree on the card.  A merged row and the first half of the
// next are contiguous in memory, but the end of a clip is not: every operand
// element at or beyond the clip's own array reads as zero, never as the next
// clip's data, and rows past the real output length are computed from such
// zeros so the next layer's merged view holds no stale values.
//
// What bounds each layer on the H100, and the design:
//   - kernel-3 layers (k3_ln_gelu_kernel; K = 1536, N = 512): tensor-core
//     operations (512 FLOP a byte of activation read and written).  The body
//     of conv_tile.cuh: row t of the operand is the 1536 contiguous values at
//     merged row t, 64 rows x 64 k of it and 64 k rows x 512 channels of W01
//     (steps 0-15) or W2 (steps 16-23), both row-major and so MN-major B
//     operands, go by cp.async through a three-stage ring in shared memory;
//     wgmma m64n256k16 products accumulate in registers and the epilogue runs
//     on the accumulators.  L2 bandwidth caps it (57 FLOP a staged byte);
//   - rows . W layers of K >= 64 (gemm_ln_gelu_kernel; the kernel-2 layers,
//     K = 1024 merged rows: operations, 341 FLOP a byte) take the same body
//     with their own addressing: operand row t is row t of the (rows, K)
//     matrix, K contiguous values at t * K (load_a_rows), W (K, 512) row-major
//     is an MN-major B; a K that is not a multiple of 64 has its last step
//     zero-filled in both tiles.  It is the kernel-3 layer without the W2
//     steps;
//   - rows . W layers of K < 64 (gemm0_ln_gelu_kernel; layer 0's patches, K =
//     16: bytes, the (T, 512) bf16 output, but ~40 instructions an output,
//     half of them the exact-erf GELU).  Tensor cores buy nothing at one K
//     step: the wgmma body's epilogue holds 128 sums a thread at one block an
//     SM and hides no latency (it made the whole-pyramid route's layer 0
//     slower than a WMMA body on the H100).  So each output is K FMAs on the
//     CUDA cores over the bf16 operands with f32 sums, tap by tap, the weight
//     (as f32) and the block's 64 rows staged once in shared memory, and the
//     epilogue runs from registers a warp a row (conv_tile.cuh:
//     lane_bias_ln_gelu_store, as conv_encoder.cu's layer 0; 32 sums a
//     thread, three blocks an SM).  Its addressing is its own: explicit
//     patches, not the waveform.
// The TPU kernel's 8-row window with a one-hot row select and its K padding
// to 8 lanes answered Mosaic's block rules and do not carry over.
#include "conv_tile.cuh"

namespace {

using mmer::bf16;
namespace conv = mmer::conv;

constexpr int C = conv::C;     // output channels
constexpr int KMIN_WGMMA = conv::KC;   // K from which a layer takes the wgmma body

// out[b, t] = epilogue(x[b, t] . w) for t < t_rows, K >= 64: the wgmma body.
// Rows of x at or beyond x_rows read as zero.
__global__ void __launch_bounds__(conv::NTHREAD, 1)
gemm_ln_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ cb, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, bf16* __restrict__ out, int x_rows,
                    int kdim, int t_rows) {
  extern __shared__ unsigned char smem_raw[];
  const conv::Shared sm = conv::carve(smem_raw);
  const int tid = threadIdx.x, t0 = blockIdx.x * conv::BM;
  const int limit = x_rows * kdim;
  const bf16* xb = x + size_t(blockIdx.y) * limit;
  conv::stage_vectors(sm.vs, cb, ln_w, ln_b, tid);

  float acc[128];
  conv::mainloop_steps<1>(
      acc, sm.ring, (kdim + conv::KC - 1) / conv::KC,
      [&](uint32_t dst, int step) {
        conv::load_a_rows(dst, xb, limit, kdim, t0, t_rows, step * conv::KC, tid);
      },
      [&](uint32_t dst, int step) {
        conv::load_b_mnmajor<true>(dst, w, step * conv::KC, tid, kdim);
      },
      tid);
  conv::bias_ln_gelu_store(acc, sm.stats, sm.vs, out + size_t(blockIdx.y) * t_rows * C, t0,
                           t_rows, tid);
}

// Shared memory of gemm0_ln_gelu_kernel: the weight as f32 (kdim x 512), the
// block's 64 operand rows as f32, the epilogue's vectors.
size_t gemm0_smem(int kdim) {
  return size_t(kdim) * C * 4 + size_t(conv::BM) * kdim * 4 + conv::VEC_BYTES;
}

// Rows a warp of gemm0_ln_gelu_kernel computes together.
constexpr int L0_PAIR = 2;

// out[b, t] = epilogue(x[b, t] . w) for t < t_rows, K < 64, on the CUDA
// cores: output (t, n) = sum over k of x[t, k] w[k, n] in f32, k by k.  Warp
// w takes rows 8w .. 8w + 7 of the block's 64, two at a time; lane l holds
// channels 128 g + 4 l + e (g, e < 4) of both rows in registers.  Rows of x
// at or beyond x_rows read as zero.
__global__ void __launch_bounds__(conv::NTHREAD, 3)
gemm0_ln_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ cb, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, bf16* __restrict__ out, int x_rows,
                     int kdim, int t_rows) {
  extern __shared__ __align__(16) float smem_f[];
  float* ws = smem_f;                                  // [k][channel]
  float* xs = ws + kdim * C;                           // [row][k]
  float* vs = xs + conv::BM * kdim;
  const int tid = threadIdx.x, t0 = blockIdx.x * conv::BM;
  const long long limit = (long long)x_rows * kdim;
  const bf16* xb = x + size_t(blockIdx.y) * limit;

  // The weight and the block's rows in 16-byte vectors of 8 values.
  for (int i = tid; i < kdim * C / 8; i += conv::NTHREAD) {
    const uint4 v = *reinterpret_cast<const uint4*>(w + size_t(i) * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ws[i * 8 + j] = __bfloat162float(e[j]);
  }
  for (int i = tid; i < conv::BM * kdim / 8; i += conv::NTHREAD) {
    const long long idx = (long long)t0 * kdim + i * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (idx < limit) v = *reinterpret_cast<const uint4*>(xb + idx);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[i * 8 + j] = __bfloat162float(e[j]);
  }
  conv::stage_vectors(vs, cb, ln_w, ln_b, tid);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const float4* ws4 = reinterpret_cast<const float4*>(ws) + lane;
  bf16* ob = out + size_t(blockIdx.y) * t_rows * C;
#pragma unroll 1
  for (int r0 = warp * (conv::BM / 8); r0 < (warp + 1) * (conv::BM / 8) && t0 + r0 < t_rows;
       r0 += L0_PAIR) {
    float acc[L0_PAIR][16];
#pragma unroll
    for (int i = 0; i < L0_PAIR; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kdim; ++k) {
      float xv[L0_PAIR];
#pragma unroll
      for (int i = 0; i < L0_PAIR; ++i) xv[i] = xs[(r0 + i) * kdim + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 wv = ws4[k * (C / 4) + 32 * g];
#pragma unroll
        for (int i = 0; i < L0_PAIR; ++i) {
          acc[i][4 * g] = fmaf(xv[i], wv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(xv[i], wv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(xv[i], wv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(xv[i], wv.w, acc[i][4 * g + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L0_PAIR; ++i)
      conv::lane_bias_ln_gelu_store(acc[i], vs, ob + size_t(t0 + r0 + i) * C, lane,
                                    t0 + r0 + i < t_rows);
  }
}

// out[b, t] = epilogue(xm[b, t] . w01 + xm[b, t + 1, :C] . w2) for t < t_rows,
// xm (batch, th, 2C): merged rows at or beyond th read as zero.
__global__ void __launch_bounds__(conv::NTHREAD, 1)
k3_ln_gelu_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ w01,
                  const bf16* __restrict__ w2, const float* __restrict__ cb,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  bf16* __restrict__ out, int th, int t_rows) {
  extern __shared__ unsigned char smem_raw[];
  const conv::Shared sm = conv::carve(smem_raw);
  const int tid = threadIdx.x, t0 = blockIdx.x * conv::BM;
  const int limit = th * 2 * C;
  conv::stage_vectors(sm.vs, cb, ln_w, ln_b, tid);

  // Row t of the operand: merged row t (taps 0 and 1, against the 2C rows of
  // W01), then the first C values of merged row t + 1 (tap 2, against W2).
  float acc[128];
  conv::mainloop<1, 3 * C / conv::KC>(
      acc, sm.ring, xm + size_t(blockIdx.y) * limit, limit, t0, t_rows,
      [&](uint32_t dst, int step) {
        const int k0 = step * conv::KC;
        if (k0 < 2 * C) conv::load_b_mnmajor(dst, w01, k0, tid);
        else conv::load_b_mnmajor(dst, w2, k0 - 2 * C, tid);
      },
      tid);
  conv::bias_ln_gelu_store(acc, sm.stats, sm.vs, out + size_t(blockIdx.y) * t_rows * C, t0,
                           t_rows, tid);
}

}  // namespace

// x: (batch, x_rows, kdim) bf16 contiguous, kdim a multiple of 16; w: (kdim, 512)
// bf16; cb, ln_w, ln_b: (512,) f32; out: (batch, t_rows, 512) bf16.  grid
// (host, two ints): the grid launched, x then y.
MMER_EXPORT int mmer_gemm_ln_gelu(const void* x, const void* w, const void* cb,
                                  const void* ln_w, const void* ln_b, void* out,
                                  int batch, int x_rows, int kdim, int c_out, int t_rows,
                                  void* stream, int* grid) {
  if (c_out != C || kdim <= 0 || kdim % 16 != 0 || batch <= 0 || x_rows <= 0 ||
      t_rows <= 0 || (long long)x_rows * kdim >= (1LL << 30) ||
      (long long)(t_rows + conv::BM) * kdim >= (1LL << 30))
    return int(cudaErrorInvalidValue);
  const dim3 g = conv::grid_of(t_rows, batch);
  grid[0] = int(g.x);
  grid[1] = int(g.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* cbf = static_cast<const float*>(cb);
  const float* lwf = static_cast<const float*>(ln_w);
  const float* lbf = static_cast<const float*>(ln_b);
  bf16* ob = static_cast<bf16*>(out);
  if (kdim >= KMIN_WGMMA)
    return int(conv::launch(gemm_ln_gelu_kernel, t_rows, batch, s, xb, wb, cbf, lwf, lbf, ob,
                            x_rows, kdim, t_rows));
  const size_t smem = gemm0_smem(kdim);
  cudaError_t err = cudaFuncSetAttribute(
      gemm0_ln_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  gemm0_ln_gelu_kernel<<<g, conv::NTHREAD, smem, s>>>(xb, wb, cbf, lwf, lbf, ob, x_rows, kdim,
                                                      t_rows);
  return int(cudaGetLastError());
}

// xm: (batch, th, 1024) bf16 contiguous, the (batch, 2*th, 512) activation
// merged in pairs; w01: (1024, 512), w2: (512, 512) bf16; cb, ln_w, ln_b:
// (512,) f32; out: (batch, t_rows, 512) bf16.
MMER_EXPORT int mmer_k3_ln_gelu(const void* xm, const void* w01, const void* w2,
                                const void* cb, const void* ln_w, const void* ln_b,
                                void* out, int batch, int th, int c_in, int c_out,
                                int t_rows, void* stream) {
  if (c_in != C || c_out != C || batch <= 0 || th <= 0 || t_rows <= 0 ||
      (long long)th * 2 * C >= (1LL << 30))
    return int(cudaErrorInvalidValue);
  return int(mmer::conv::launch(
      k3_ln_gelu_kernel, t_rows, batch, static_cast<cudaStream_t>(stream),
      static_cast<const bf16*>(xm), static_cast<const bf16*>(w01), static_cast<const bf16*>(w2),
      static_cast<const float*>(cb), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), th, t_rows));
}
