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
//   - layer 0 (K = 16; bytes: the (T, 512) bf16 output) and kernel-2 layers
//     (K = 1024; operations) go through gemm_ln_gelu_kernel, a WMMA body: a
//     block owns 32 output rows and all 512 channels; 8 warps, each a 16-row x
//     128-channel slab of f32 accumulators; 32 rows x 64 taps of the operand
//     are staged in shared memory per step as 16-byte vectors, the weight is
//     read straight from global memory (at most 1 MB, L2-resident), and the
//     accumulators go through a shared f32 tile into one warp per row of the
//     common epilogue.  The TPU kernel's 8-row window with a one-hot row
//     select and its K padding to 8 lanes answered Mosaic's block rules and do
//     not carry over.
#include "conv_tile.cuh"

namespace {

using mmer::bf16;
using namespace nvcuda;

constexpr int C = 512;        // output channels
constexpr int BT = 32;        // output rows per block
constexpr int KC = 64;        // operand columns staged per step
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int LDA = KC + 8;   // bf16 row stride of the staged operand rows
constexpr int LDY = C + 4;    // f32 row stride of the product tile
constexpr int NT = (C / 4) / 16;  // col tiles per warp: 4 column groups x 2 row tiles

constexpr size_t SMEM_BYTES =
    size_t(BT) * LDA * sizeof(bf16) + size_t(BT) * LDY * sizeof(float);

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += A . W for the block's BT rows.  Row r of A is the kdim contiguous
// elements of xb that start at (t0 + r) * row_stride + col_off; elements at
// or beyond `limit` (the end of this clip's array) and rows at or beyond
// t_rows read as zero.  W is (kdim, C) row-major.  Every offset is a
// multiple of 8 elements, so the operand moves as 16-byte vectors.
__device__ __forceinline__ void mma_rows(Acc (&acc)[NT], const bf16* __restrict__ xb,
                                         long long limit, int row_stride, int col_off,
                                         int kdim, const bf16* __restrict__ w, bf16* as,
                                         int t0, int t_rows, int tid, int rt, int col0) {
  for (int k0 = 0; k0 < kdim; k0 += KC) {
    const int kc = min(KC, kdim - k0);  // a multiple of 16
    __syncthreads();
    for (int i = tid; i < BT * (KC / 8); i += NTHREAD) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      const long long idx = (long long)(t0 + r) * row_stride + col_off + k0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c < kc && t0 + r < t_rows && idx < limit)
        v = *reinterpret_cast<const uint4*>(xb + idx);
      *reinterpret_cast<uint4*>(as + r * LDA + c) = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, as + rt * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w + size_t(k0 + kk) * C + col0 + j * 16, C);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
}

// The accumulators to shared memory, then one warp per output row through the
// shared epilogue.
__device__ __forceinline__ void finish_rows(Acc (&acc)[NT], float* ys,
                                            const float* __restrict__ cb,
                                            const float* __restrict__ ln_w,
                                            const float* __restrict__ ln_b,
                                            bf16* __restrict__ out_b, int t0, int t_rows,
                                            int warp, int lane, int rt, int col0) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(ys + rt * 16 * LDY + col0 + j * 16, acc[j], LDY,
                            wmma::mem_row_major);
  __syncthreads();
  for (int r = warp; r < BT; r += NWARP) {
    const int t = t0 + r;
    if (t < t_rows)
      mmer::bias_ln_gelu_row<C>(ys + r * LDY, cb, ln_w, ln_b, out_b + size_t(t) * C, lane);
  }
}

// out[b, t] = epilogue(x[b, t] . w) for t < t_rows; rows of x at or beyond
// x_rows read as zero.
__global__ void __launch_bounds__(NTHREAD)
gemm_ln_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ cb, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, bf16* __restrict__ out, int x_rows,
                    int kdim, int t_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  float* ys = reinterpret_cast<float*>(smem + size_t(BT) * LDA * sizeof(bf16));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BT;
  const int rt = warp & 1, col0 = (warp >> 1) * (C / 4);
  const long long limit = (long long)x_rows * kdim;

  Acc acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.f);
  mma_rows(acc, x + size_t(blockIdx.y) * limit, limit, kdim, 0, kdim, w, as, t0, t_rows,
           tid, rt, col0);
  finish_rows(acc, ys, cb, ln_w, ln_b, out + size_t(blockIdx.y) * t_rows * C, t0, t_rows,
              warp, lane, rt, col0);
}

// out[b, t] = epilogue(xm[b, t] . w01 + xm[b, t + 1, :C] . w2) for t < t_rows,
// xm (batch, th, 2C): merged rows at or beyond th read as zero.
__global__ void __launch_bounds__(mmer::conv::NTHREAD, 1)
k3_ln_gelu_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ w01,
                  const bf16* __restrict__ w2, const float* __restrict__ cb,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  bf16* __restrict__ out, int th, int t_rows) {
  namespace conv = mmer::conv;
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

template <typename K>
cudaError_t allow_smem(K kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(SMEM_BYTES));
}

}  // namespace

// x: (batch, x_rows, kdim) bf16 contiguous, kdim a multiple of 16; w: (kdim, 512)
// bf16; cb, ln_w, ln_b: (512,) f32; out: (batch, t_rows, 512) bf16.
MMER_EXPORT int mmer_gemm_ln_gelu(const void* x, const void* w, const void* cb,
                                  const void* ln_w, const void* ln_b, void* out,
                                  int batch, int x_rows, int kdim, int c_out, int t_rows,
                                  void* stream) {
  if (c_out != C || kdim <= 0 || kdim % 16 != 0 || batch <= 0 || x_rows <= 0 ||
      t_rows <= 0)
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(gemm_ln_gelu_kernel);
  if (err != cudaSuccess) return int(err);
  dim3 grid((t_rows + BT - 1) / BT, batch);
  gemm_ln_gelu_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(cb), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), x_rows, kdim, t_rows);
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
