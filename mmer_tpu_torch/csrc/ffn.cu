// Fused pre-norm FFN sublayer:  out = x + GELU_erf(LN(x) W1^T + b1) W2^T + b2
//
// Replaces the Pallas kernel mmer_tpu/ops/fused_blocks.py:_ffn_kernel (public
// fused_ffn).  Same numerics: LayerNorm in float32 (flax: eps 1e-6,
// var = max(0, E[x^2] - E[x]^2)), LN output rounded to bf16 for the first
// GEMM, f32 accumulation, bias + exact-erf GELU in f32, hidden rounded to
// bf16 for the second GEMM, residual and output bias in f32, output in x's
// dtype (bf16 for the ViViT stream, f32 for the Wav2Vec2 stream).
//
// What bounds it on the H100: tensor-core throughput.  At the ViViT shape
// (12,552 tokens, D 768, M 3072) one call is 118 GFLOP against 9.4 MB of
// weights and 38 MB of activations, far above the card's ~295 FLOP/byte
// ridge.  The design keeps the (tokens, M) hidden tensor out of device
// memory, which is the point of the TPU kernel too: a block owns BM = 32
// token rows and walks the hidden dimension in MC = 128 chunks inside the
// block (Hopper has no sequential grid, so the TPU's "arbitrary" M grid axis
// becomes this loop).  The (32, D) f32 output accumulator lives in
// registers for the whole loop (8 warps x D/8 columns each), the bf16 LN
// tile in shared memory.  Tensor-core tiles are WMMA 16x16x16 bf16 with
// weight fragments read straight from global memory (the 6-8 MB of weights
// stay L2-resident across blocks).  wgmma/TMA staging is later work.
//
// Weights use the nn.Linear layout: w1 (M, D), w2 (D, M), both bf16; they are
// read as column-major B operands, so no transposed copy is needed.
#include "common.cuh"

namespace {

using mmer::bf16;
using namespace nvcuda;

constexpr int BM = 32;       // token rows per block
constexpr int MC = 128;      // hidden units per chunk
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int LDH = MC + 4;  // f32 hidden chunk row stride
constexpr int LDHB = MC + 8; // bf16 hidden chunk row stride

template <int D>
constexpr size_t smem_bytes() {
  return size_t(BM) * (D + 8) * sizeof(bf16) + size_t(BM) * LDH * sizeof(float) +
         size_t(BM) * LDHB * sizeof(bf16);
}

template <int D, typename XT>
__global__ void __launch_bounds__(NTHREAD, 1)
ffn_kernel(const XT* __restrict__ x, const float* __restrict__ ln_w,
           const float* __restrict__ ln_b, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, XT* __restrict__ out, int n_tok, int m) {
  constexpr int LDY = D + 8;    // bf16 row stride of the LN tile
  constexpr int COLS = D / NWARP;   // output columns per warp
  constexpr int NT = COLS / 16;     // output col tiles per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(smem + size_t(BM) * LDY * sizeof(bf16));
  bf16* hb = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(hs) +
                                     size_t(BM) * LDH * sizeof(float));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long n0 = long(blockIdx.x) * BM;

  // LayerNorm of the block's rows, rounded to bf16 (rows past n_tok are 0).
  mmer::ln_tile_bf16<D>(x, ln_w, ln_b, ys, LDY, n0, n_tok, BM, warp, NWARP, lane);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[r][j], 0.f);

  for (int mc = 0; mc < m; mc += MC) {
    // GEMM 1: hidden chunk (32 x 128) = LN(x) (32 x D) . W1[mc:mc+128]^T.
    // Warp w owns hidden columns [16w, 16w+16) for both 16-row tiles.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h[2];
      wmma::fill_fragment(h[0], 0.f);
      wmma::fill_fragment(h[1], 0.f);
      const bf16* wcol = w1 + size_t(mc + warp * 16) * D;
#pragma unroll 4
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, wcol + k, D);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, ys + r * 16 * LDY + k, LDY);
          wmma::mma_sync(h[r], a, b, h[r]);
        }
      }
      wmma::store_matrix_sync(hs + warp * 16, h[0], LDH, wmma::mem_row_major);
      wmma::store_matrix_sync(hs + 16 * LDH + warp * 16, h[1], LDH, wmma::mem_row_major);
    }
    __syncthreads();

    // Bias + exact-erf GELU in f32, rounded to bf16 for GEMM 2.
    for (int i = tid; i < BM * MC; i += NTHREAD) {
      const int r = i / MC, c = i % MC;
      hb[r * LDHB + c] = __float2bfloat16_rn(mmer::gelu_erf(hs[r * LDH + c] + b1[mc + c]));
    }
    __syncthreads();

    // GEMM 2: acc (32 x D) += hidden (32 x 128) . W2[:, mc:mc+128]^T.
    // Warp w owns output columns [w*COLS, (w+1)*COLS).
#pragma unroll
    for (int k = 0; k < MC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], hb + k, LDHB);
      wmma::load_matrix_sync(a[1], hb + 16 * LDHB + k, LDHB);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w2 + size_t(warp * COLS + j * 16) * m + mc + k, m);
        wmma::mma_sync(acc[0][j], a[0], b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a[1], b, acc[1][j]);
      }
    }
  }
  __syncthreads();

  // Epilogue: out = x + acc + b2, through a per-warp 16x16 f32 scratch tile.
  float* scr = hs + warp * 256;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      wmma::store_matrix_sync(scr, acc[r][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long n = n0 + r * 16 + e / 16;
        const int col = warp * COLS + j * 16 + e % 16;
        if (n < n_tok) {
          const float o = mmer::to_f32(x[n * D + col]) + scr[e] + b2[col];
          out[n * D + col] = mmer::from_f32<XT>(o);
        }
      }
      __syncwarp();
    }
  }
}

template <int D, typename XT>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, int n_tok,
           int m, cudaStream_t stream) {
  auto kern = ffn_kernel<D, XT>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((n_tok + BM - 1) / BM);
  kern<<<grid, NTHREAD, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<XT*>(out), n_tok, m);
  return int(cudaGetLastError());
}

}  // namespace

// x, out: (n_tok, d) in bf16 (x_is_f32 = 0) or f32 (x_is_f32 = 1);
// ln_w, ln_b, b1 (m), b2 (d): f32; w1 (m, d), w2 (d, m): bf16.
// d must be 768 or 1024 and m a multiple of 128.
MMER_EXPORT int mmer_fused_ffn(const void* x, const void* ln_w, const void* ln_b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int n_tok, int d, int m,
                               int x_is_f32, void* stream) {
  if (m % MC != 0 || n_tok <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 768)
    return x_is_f32 ? launch<768, float>(x, ln_w, ln_b, w1, b1, w2, b2, out, n_tok, m, s)
                    : launch<768, bf16>(x, ln_w, ln_b, w1, b1, w2, b2, out, n_tok, m, s);
  if (d == 1024)
    return x_is_f32 ? launch<1024, float>(x, ln_w, ln_b, w1, b1, w2, b2, out, n_tok, m, s)
                    : launch<1024, bf16>(x, ln_w, ln_b, w1, b1, w2, b2, out, n_tok, m, s);
  return int(cudaErrorInvalidValue);
}
