// Non-causal multi-head attention, softmax(q k^T / sqrt(d)) v, over
// (B, H, S, 64) bf16 tensors, with keys at or beyond S masked out.
//
// Replaces the Pallas kernel mmer_tpu/ops/flash_attention.py:_attn_kernel
// (flash_attention with key_lens=None).  Same numerics: scores, softmax
// statistics and the output accumulator in f32; probabilities rounded to
// bf16 before the P.V product, and the softmax denominator summed from those
// rounded probabilities (the TPU kernel gets it from a ones column in V);
// the output normalised once at the end.
//
// What bounds it on the H100: at the ViViT shape (8 x 12 heads, S = 1569,
// d = 64) a call is 60 GFLOP of tensor-core work against 77 MB of q/k/v/o,
// so it is compute bound once the (S, S) score matrix stays on chip -- which is
// what an online softmax buys: nothing but the (S, 64) output returns to
// device memory.  One block per (batch*head, 64-query tile); four warps own
// 16 query rows each; K/V tiles of 64 keys are staged in shared memory and
// shared by the four warps; running max, sum and the f32 output tile are
// kept per warp.  Products are WMMA 16x16x16 bf16 tiles.  The TPU tiling
// (BQ = 416, six heads per program, the ones column in V) answered the
// TPU's per-program overhead and does not carry over.
#include <math_constants.h>

#include "common.cuh"

namespace {

using mmer::bf16;
using namespace nvcuda;

constexpr int HD = 64;       // head dim
constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per tile
constexpr int NWARP = BQ / 16;
constexpr int NTHREAD = NWARP * 32;
constexpr int LDB = HD + 8;  // bf16 row stride of Q/K/V/P tiles
constexpr int LDF = HD + 4;  // f32 row stride of score and output tiles

static_assert(BK == HD, "score and output tiles share one stride");

constexpr size_t SMEM_BYTES = size_t(BQ + 2 * BK) * LDB * sizeof(bf16)  // Q, K, V
                              + size_t(BQ) * LDB * sizeof(bf16)        // P
                              + size_t(2 * BQ) * LDF * sizeof(float);  // S, O

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int s,
                                          int tid) {
  // 64 rows x 64 bf16 as 16-byte vectors; rows >= s are zero-filled.
  for (int i = tid; i < 64 * (HD / 8); i += NTHREAD) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < s) v = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = v;
  }
}

__global__ void __launch_bounds__(NTHREAD)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int s, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * LDB;
  bf16* vs = ks + BK * LDB;
  bf16* ps = vs + BK * LDB;
  float* ss = reinterpret_cast<float*>(ps + BQ * LDB);
  float* os = ss + BQ * LDF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = size_t(blockIdx.y) * s * HD;
  const int q0 = blockIdx.x * BQ;

  load_tile(qs, q + base, q0, s, tid);

  // Each lane owns half a row (32 columns) of its warp's 16 rows.
  const int row = lane >> 1, half = lane & 1;
  float* srow = ss + (warp * 16 + row) * LDF + half * 32;
  float* orow = os + (warp * 16 + row) * LDF + half * 32;
  bf16* prow = ps + (warp * 16 + row) * LDB + half * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) orow[j] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qs + warp * 16 * LDB + kk * 16, LDB);

  float m_run = -CUDART_INF_F, l_run = 0.f;
  for (int k0 = 0; k0 < s; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(ks, k + base, k0, s, tid);
    load_tile(vs, v + base, k0, s, tid);
    __syncthreads();

    // Scores: (16 x 64) per warp = Q (16 x 64) . K_tile^T.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ks + n * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(c, qf[kk], b, c);
      }
      wmma::store_matrix_sync(ss + warp * 16 * LDF + n * 16, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on this lane's half row.
    const int key0 = k0 + half * 32;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float sc = key0 + j < s ? srow[j] * scale : -CUDART_INF_F;
      srow[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bf16 p = __float2bfloat16_rn(expf(srow[j] - m_new));
      prow[j] = p;
      sum += __bfloat162float(p);
      orow[j] *= alpha;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();

    // O (16 x 64) += P (16 x 64 keys) . V_tile (64 keys x 64).
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* otile = os + warp * 16 * LDF + n * 16;
      wmma::load_matrix_sync(c, otile, LDF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + warp * 16 * LDB + kk * 16, LDB);
        wmma::load_matrix_sync(b, vs + kk * 16 * LDB + n * 16, LDB);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(otile, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qi = q0 + warp * 16 + row;
  if (qi < s) {
    const float inv = 1.0f / l_run;
    bf16* dst = o + base + size_t(qi) * HD + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[j] = __float2bfloat16_rn(orow[j] * inv);
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, s, 64) bf16.
MMER_EXPORT int mmer_attention(const void* q, const void* k, const void* v, void* o,
                               int bh, int s, int d, float scale, void* stream) {
  if (d != HD || s <= 0 || bh <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  dim3 grid((s + BQ - 1) / BQ, bh);
  attention_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), s, scale);
  return int(cudaGetLastError());
}
