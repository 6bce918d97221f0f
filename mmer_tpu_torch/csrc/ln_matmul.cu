// Fused LayerNorm + matrix product:  out = LN(x) W^T, the LN output never
// written to device memory.
//
// Replaces the Pallas kernel mmer_tpu/ops/fused_blocks.py:_ln_matmul_kernel
// (public fused_ln_matmul; the ViViT LN -> QKV projection).  Same numerics:
// LayerNorm in float32 (flax: eps 1e-6, var = max(0, E[x^2] - E[x]^2)),
// rounded to the weight's dtype (bf16), product accumulated in f32, one
// rounding to bf16 on store.  The output takes the weight's dtype, not x's.
//
// What bounds it on the H100: tensor-core throughput.  At the profile shape
// (25,104 tokens, D 768, N 2304) a call is 88.8 GFLOP against 158 MB (38.6 MB
// of x, 3.5 MB of W, 115.7 MB of output), ~560 FLOP/byte, above the card's
// ~295 FLOP/byte ridge; the output is three times as wide as x, so the store
// path moves most of the bytes.  A block owns BM = 64 token rows: their LN
// statistics are computed once (the prologue ffn.cu also uses,
// common.cuh:ln_tile_bf16), the bf16 LN tile stays in shared memory, and the
// block walks N in tiles of 256 columns (Hopper has no sequential grid: the
// TPU kernel's whole-N block becomes this loop).  Eight warps as 2 row halves
// x 4 column groups: a warp holds a (32, 64) f32 accumulator as 2 x 4 WMMA
// 16x16x16 fragments, so each weight fragment read from global memory (L2
// resident: W is 3.5-6 MB) feeds two row tiles.  The epilogue goes through a
// per-warp f32 scratch tile so that each lane rounds and stores 32 contiguous
// bf16 values (four 16-byte stores).  Rows past the last token are zero in the
// LN tile (never read from x) and are never stored.
//
// The weight uses the nn.Linear layout, w (N, D) bf16, read as a column-major
// B operand: no transposed copy is needed.
#include "common.cuh"

namespace {

using mmer::bf16;
using namespace nvcuda;

constexpr int BM = 64;        // token rows per block
constexpr int BN = 256;       // output columns per tile of the N loop
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int WN = 64;        // output columns per warp and tile
constexpr int LDS = WN + 4;   // f32 row stride of a warp's scratch tile

template <int D>
constexpr size_t smem_bytes() {
  return size_t(BM) * (D + 8) * sizeof(bf16) + size_t(NWARP) * 16 * LDS * sizeof(float);
}

template <int D, typename XT>
__global__ void __launch_bounds__(NTHREAD, 1)
ln_matmul_kernel(const XT* __restrict__ x, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w,
                 bf16* __restrict__ out, int n_tok, int n) {
  constexpr int LDY = D + 8;    // bf16 row stride of the LN tile

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + size_t(BM) * LDY * sizeof(bf16));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long n0 = long(blockIdx.x) * BM;

  mmer::ln_tile_bf16<D>(x, ln_w, ln_b, ys, LDY, n0, n_tok, BM, warp, NWARP, lane);
  __syncthreads();

  const int wr = warp >> 2;             // row half: rows [32 wr, 32 wr + 32)
  const int wc = warp & 3;              // column group within the tile
  float* scr = scratch + warp * 16 * LDS;
  const int srow = lane >> 1, shalf = lane & 1;   // the lane's part of a scratch tile

  for (int c0 = wc * WN; c0 < n; c0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][WN / 16];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[r][j], 0.f);

    const bf16* wcol = w + size_t(c0) * D;
#pragma unroll 2
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], ys + (wr * 32) * LDY + k, LDY);
      wmma::load_matrix_sync(a[1], ys + (wr * 32 + 16) * LDY + k, LDY);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, wcol + size_t(j * 16) * D + k, D);
        wmma::mma_sync(acc[0][j], a[0], b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a[1], b, acc[1][j]);
      }
    }

    // Epilogue: 16 rows x 64 columns at a time through the warp's scratch
    // tile; each lane rounds half a row and stores it as four 16-byte vectors.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::store_matrix_sync(scr + j * 16, acc[r][j], LDS, wmma::mem_row_major);
      __syncwarp();
      const long tok = n0 + wr * 32 + r * 16 + srow;
      if (tok < n_tok) {
        const float* src = scr + srow * LDS + shalf * 32;
        bf16* dst = out + tok * n + c0 + shalf * 32;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          __align__(16) bf16 pack[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) pack[e] = __float2bfloat16_rn(src[v * 8 + e]);
          *reinterpret_cast<uint4*>(dst + v * 8) = *reinterpret_cast<const uint4*>(pack);
        }
      }
      __syncwarp();
    }
  }
}

template <int D, typename XT>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, void* out,
           int n_tok, int n, cudaStream_t stream) {
  auto kern = ln_matmul_kernel<D, XT>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((n_tok + BM - 1) / BM);
  kern<<<grid, NTHREAD, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), n_tok, n);
  return int(cudaGetLastError());
}

}  // namespace

// x: (n_tok, d) in bf16 (x_is_f32 = 0) or f32 (x_is_f32 = 1); ln_w, ln_b: (d,)
// f32; w: (n, d) bf16; out: (n_tok, n) bf16.  d must be 768 or 1024 and n a
// multiple of 64.
MMER_EXPORT int mmer_fused_ln_matmul(const void* x, const void* ln_w, const void* ln_b,
                                     const void* w, void* out, int n_tok, int d, int n,
                                     int x_is_f32, void* stream) {
  if (n <= 0 || n % WN != 0 || n_tok <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 768)
    return x_is_f32 ? launch<768, float>(x, ln_w, ln_b, w, out, n_tok, n, s)
                    : launch<768, bf16>(x, ln_w, ln_b, w, out, n_tok, n, s);
  if (d == 1024)
    return x_is_f32 ? launch<1024, float>(x, ln_w, ln_b, w, out, n_tok, n, s)
                    : launch<1024, bf16>(x, ln_w, ln_b, w, out, n_tok, n, s);
  return int(cudaErrorInvalidValue);
}
