// Non-causal multi-head attention, softmax(q k^T / sqrt(d)) v, over
// (B, H, S, 64) bf16 tensors, with keys at or beyond S masked out, and
// optionally one key length per batch element.
//
// Replaces the Pallas kernels mmer_tpu/ops/flash_attention.py:_attn_kernel
// (flash_attention with key_lens=None, ViViT) and :_attn_kernel_varlen
// (flash_attention with key_lens, Wav2Vec2: clips shorter than the padded
// batch attend to their own frames only).  Same numerics: scores, softmax
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
//
// The key-length variant is the same kernel with one length per
// blockIdx.y / heads (the TPU kernel's SMEM length vector indexed by
// program_id becomes one global load per block).  Keys in [len, S) get a
// finite additive bias of -1e9, not -inf: next to any valid key their
// probability is an exact zero, so tiles wholly past len are skipped; a row
// with len == 0 has the bias on every key and comes out as the uniform
// average over all S keys, never NaN (no tile is skipped for it).  Keys at
// or beyond S do not exist and stay at -inf.  At the extraction shape
// (64 clips x 16 heads, S = 249, lengths in [0.3 S, S]) a call needs ~11 GFLOP
// and ~108 MB (q and o in full, the k and v rows below each clip's length):
// bound by bytes, 4 blocks of 64 queries per (clip, head).
//
// The probe variants (mmer_attention_variant) are this same body under other
// template parameters; they replace the ablated kernels of
// scripts/probe_attn.py (_kernel, _kernel_kt, _kernel_mxumask), so that the
// ablations time this kernel and follow its later redesign:
//   softmax mode  SOFTMAX_MASKED  keys >= S are -inf (the production kernel);
//                 SOFTMAX_NOMASK  every key of the zero-padded length S_pad
//                                 takes part, no bounds check in the score pass;
//                 SHIFT_ONLY      p = score - row max, no exp: the online
//                                 rescale becomes a subtraction,
//                                 O -= (m_new - m_old) * (sum of the V rows so
//                                 far), so the result is the whole-row one;
//                 PRODUCTS_ONLY   p = score: no max, no exp, no rescale code
//                                 at all (the tensor-core floor of the design);
//   K layout      KT: K arrives as (64, S_pad) per head and its tile is read
//                 as a row-major B operand;
//   depth         DQK = 80: q and k carry a 65th column (ones / 0 or -1e9 on
//                 padded keys) that folds the key mask into the first product,
//                 zero-padded to a multiple of the 16-deep WMMA step.
// Keys in [S, S_pad) are zero rows: K and V tiles are zero-filled past the
// rows that exist in memory, so no padded copy of k or v is needed (the
// 65-column K, whose padded rows hold the bias, is materialised by its
// caller).  Padded query rows are never loaded into a result nor written.
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
constexpr int LDB = HD + 8;  // bf16 row stride of V/P tiles (and Q/K at depth 64)
constexpr int LDF = HD + 4;  // f32 row stride of score and output tiles

static_assert(BK == HD, "score and output tiles share one stride");

enum Softmax { SOFTMAX_MASKED = 0, SOFTMAX_NOMASK = 1, SHIFT_ONLY = 2, PRODUCTS_ONLY = 3 };

template <int DQK>
constexpr size_t smem_bytes() {
  return size_t(BQ + BK) * (DQK + 8) * sizeof(bf16)       // Q, K
         + size_t(BK + BQ) * LDB * sizeof(bf16)            // V, P
         + size_t(2 * BQ) * LDF * sizeof(float)            // S, O
         + size_t(HD) * sizeof(float);                     // column sums of a V tile
}

// 64 rows x DEPTH bf16 as 16-byte vectors into a tile of row stride DEPTH + 8;
// rows >= rows_in_memory are zero-filled.
template <int DEPTH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int rows_in_memory, int tid) {
  for (int i = tid; i < 64 * (DEPTH / 8); i += NTHREAD) {
    const int r = i / (DEPTH / 8), c = (i % (DEPTH / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows_in_memory)
      v = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * DEPTH + c);
    *reinterpret_cast<uint4*>(dst + r * (DEPTH + 8) + c) = v;
  }
}

// A (64 depth) x (64 keys) tile of a pre-transposed K (64, s_pad), keys
// [k0, k0 + 64), which all exist (s_pad is a multiple of 64).
__device__ __forceinline__ void load_tile_kt(bf16* dst, const bf16* src, int k0, int s_pad,
                                             int tid) {
  for (int i = tid; i < HD * (BK / 8); i += NTHREAD) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDB + c) =
        *reinterpret_cast<const uint4*>(src + size_t(r) * s_pad + k0 + c);
  }
}

constexpr float KEY_BIAS = -1e9f;  // on keys in [len, S)

// q: (bh, s, DQK); k: (bh, k_rows, DQK), or (bh, 64, k_rows) when KT; v, o:
// (bh, s, 64).  Keys [0, s_keys) are visited; k rows >= k_rows and v rows >= s
// read as zero.
template <bool VARLEN, int SM, bool KT, int DQK>
__global__ void __launch_bounds__(NTHREAD)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ lens, int heads, int s, int s_keys, int k_rows,
                 float scale) {
  static_assert(!KT || DQK == HD, "the transposed K layout has depth 64");
  constexpr int LDQ = DQK + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * LDQ;
  bf16* vs = ks + BK * LDQ;
  bf16* ps = vs + BK * LDB;
  float* ss = reinterpret_cast<float*>(ps + BQ * LDB);
  float* os = ss + BQ * LDF;
  float* vsum = os + BQ * LDF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = size_t(blockIdx.y) * s * HD;
  const bf16* qb = q + size_t(blockIdx.y) * s * DQK;
  const bf16* kb = k + size_t(blockIdx.y) * k_rows * DQK;
  const int q0 = blockIdx.x * BQ;
  const int len = VARLEN ? min(lens[blockIdx.y / heads], s) : s_keys;
  const int kend = len > 0 ? len : s_keys;

  load_tile<DQK>(qs, qb, q0, s, tid);

  // Each lane owns half a row (32 columns) of its warp's 16 rows.
  const int row = lane >> 1, half = lane & 1;
  float* srow = ss + (warp * 16 + row) * LDF + half * 32;
  float* orow = os + (warp * 16 + row) * LDF + half * 32;
  bf16* prow = ps + (warp * 16 + row) * LDB + half * 32;
#pragma unroll
  for (int j = 0; j < 32; ++j) orow[j] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DQK / 16];
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qs + warp * 16 * LDQ + kk * 16, LDQ);

  float m_run = -CUDART_INF_F, l_run = 0.f;
  float vrun[SM == SHIFT_ONLY ? 32 : 1];   // column sums of the V rows so far
  float n_prev = 0.f;                      // and their number
  if constexpr (SM == SHIFT_ONLY) {
#pragma unroll
    for (int j = 0; j < 32; ++j) vrun[j] = 0.f;
  }
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    if constexpr (KT) load_tile_kt(ks, kb, k0, k_rows, tid);
    else load_tile<DQK>(ks, kb, k0, k_rows, tid);
    load_tile<HD>(vs, v + base, k0, s, tid);
    __syncthreads();
    if constexpr (SM == SHIFT_ONLY) {
      if (tid < HD) {
        float acc = 0.f;
        for (int r = 0; r < BK; ++r) acc += __bfloat162float(vs[r * LDB + tid]);
        vsum[tid] = acc;
      }
      __syncthreads();
    }

    // Scores: (16 x 64) per warp = Q (16 x DQK) . K_tile^T.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        if constexpr (KT) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ks + kk * 16 * LDB + n * 16, LDB);
          wmma::mma_sync(c, qf[kk], b, c);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, ks + n * 16 * LDQ + kk * 16, LDQ);
          wmma::mma_sync(c, qf[kk], b, c);
        }
      }
      wmma::store_matrix_sync(ss + warp * 16 * LDF + n * 16, c, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    const int key0 = k0 + half * 32;
    if constexpr (SM == PRODUCTS_ONLY) {
      // p = score: nothing but the rounding between the two products.
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const bf16 p = __float2bfloat16_rn(srow[j] * scale);
        prow[j] = p;
        sum += __bfloat162float(p);
      }
      l_run += sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    } else {
      // Online softmax on this lane's half row.
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float sc;
        if constexpr (SM == SOFTMAX_MASKED) {
          sc = -CUDART_INF_F;
          if (key0 + j < s_keys) {
            sc = srow[j] * scale;
            if (VARLEN && key0 + j >= len) sc += KEY_BIAS;
          }
        } else {
          sc = srow[j] * scale;
        }
        srow[j] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      if constexpr (SM == SHIFT_ONLY) {
        // p = score - max.  Rows summed so far were shifted by the old max:
        // move them to the new one.
        const float delta = k0 == 0 ? 0.f : m_new - m_run;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const bf16 p = __float2bfloat16_rn(srow[j] - m_new);
          prow[j] = p;
          sum += __bfloat162float(p);
          orow[j] -= delta * vrun[j];
          vrun[j] += vsum[half * 32 + j];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l_run = l_run - delta * n_prev + sum;
        n_prev += float(BK);
      } else {
        const float alpha = expf(m_run - m_new);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const bf16 p = __float2bfloat16_rn(expf(srow[j] - m_new));
          prow[j] = p;
          sum += __bfloat162float(p);
          orow[j] *= alpha;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l_run = l_run * alpha + sum;
      }
      m_run = m_new;
    }
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

template <bool VARLEN, int SM, bool KT, int DQK>
int launch(const void* q, const void* k, const void* v, void* o, const void* lens,
           int bh, int heads, int s, int s_keys, int k_rows, float scale, void* stream) {
  if (s <= 0 || bh <= 0 || heads <= 0 || bh % heads != 0 || s_keys < s)
    return int(cudaErrorInvalidValue);
  auto kern = attention_kernel<VARLEN, SM, KT, DQK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes<DQK>()));
  if (err != cudaSuccess) return int(err);
  dim3 grid((s + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREAD, smem_bytes<DQK>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<const int*>(lens), heads, s, s_keys, k_rows, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (bh, s, 64) bf16.
MMER_EXPORT int mmer_attention(const void* q, const void* k, const void* v, void* o,
                               int bh, int s, int d, float scale, void* stream) {
  if (d != HD) return int(cudaErrorInvalidValue);
  return launch<false, SOFTMAX_MASKED, false, HD>(q, k, v, o, nullptr, bh, 1, s, s, s,
                                                  scale, stream);
}

// q, k, v, o: contiguous (b, h, s, 64) bf16; lens: (b,) int32 on the device,
// the number of leading keys each batch element attends to (values above s
// count as s, values below 1 as 0).
MMER_EXPORT int mmer_attention_varlen(const void* q, const void* k, const void* v,
                                      void* o, const void* lens, int b, int h, int s,
                                      int d, float scale, void* stream) {
  if (b <= 0 || h <= 0 || lens == nullptr || d != HD) return int(cudaErrorInvalidValue);
  return launch<true, SOFTMAX_MASKED, false, HD>(q, k, v, o, lens, b * h, h, s, s, s,
                                                 scale, stream);
}

// The probe variants.  v, o: contiguous (bh, s, 64) bf16; s_pad, a multiple
// of 64 and at least s, is the zero-padded key length.  By variant:
//   0 nomask, 1 noexp, 2 nosoftmax: q, k (bh, s, 64); keys [s, s_pad) are zero
//     rows that take part;
//   3 mxumask: q (bh, s, 80), k (bh, s_pad, 80), the mask in their 65th column;
//   4 kt, 5 kt_nosoftmax: q (bh, s, 64), k (bh, 64, s_pad) pre-transposed;
//     kt masks keys >= s as the production kernel does.
MMER_EXPORT int mmer_attention_variant(int variant, const void* q, const void* k,
                                       const void* v, void* o, int bh, int s, int s_pad,
                                       float scale, void* stream) {
  if (s_pad < s || s_pad % BK != 0) return int(cudaErrorInvalidValue);
  switch (variant) {
    case 0:
      return launch<false, SOFTMAX_NOMASK, false, HD>(q, k, v, o, nullptr, bh, 1, s, s_pad,
                                                      s, scale, stream);
    case 1:
      return launch<false, SHIFT_ONLY, false, HD>(q, k, v, o, nullptr, bh, 1, s, s_pad, s,
                                                  scale, stream);
    case 2:
      return launch<false, PRODUCTS_ONLY, false, HD>(q, k, v, o, nullptr, bh, 1, s, s_pad,
                                                     s, scale, stream);
    case 3:
      return launch<false, SOFTMAX_NOMASK, false, 80>(q, k, v, o, nullptr, bh, 1, s, s_pad,
                                                      s_pad, scale, stream);
    case 4:
      return launch<false, SOFTMAX_MASKED, true, HD>(q, k, v, o, nullptr, bh, 1, s, s,
                                                     s_pad, scale, stream);
    case 5:
      return launch<false, PRODUCTS_ONLY, true, HD>(q, k, v, o, nullptr, bh, 1, s, s_pad,
                                                    s_pad, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
