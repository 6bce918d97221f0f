// Wav2Vec2's plain attention, the arithmetic of EncoderLayer._attention's
// plain route (models/wav2vec2.py), in one launch a layer.  Over q, k, v
// (B, T, H * 64) bf16 as the projections leave them (row stride ``ld``, so
// the fused projection's column slices are read in place) and a (B, T) pad
// mask (bytes, nonzero on padded frames; or none), for each row b, head h
// and query frame i:
//   s_j = (q_i . k_j in f32) / 8                     (exact: a power of two)
//   s_j = s_j + (-1e9) in f32 on padded keys j
//   m = max_j s_j,  l = sum_j exp(s_j - m)           (f32, the whole row)
//   P_j = bf16(exp(s_j - m) / l)
//   o_i = sum_j P_j v_j in f32, rounded once to bf16 (the rounding the out
//         projection's operand takes: dense() casts its input to bf16)
// written to o (B, T, H * 64) bf16.  Every query row is computed, padded
// ones too.  A row whose keys are all padded comes out as the plain route's
// (every score -1e9 + s_j, rounded in f32: uniform where |s_j| < 32).
//
// Not a TPU kernel: XLA compiles the JAX package's _xla_attention
// (mmer_tpu/models/wav2vec2.py:304).  The torch ops it replaces materialise
// the f32 score tensor, (64, 16, 499, 499) = 1.02 GB a layer at the long
// extraction shape, and pass over it about ten times (the f32 GEMM, the
// scale, the mask add, the softmax, the bf16 cast and back, the P.V read).
// Here the scores never leave registers.
//
// What bounds it on the H100: 4 T^2 64 operations a (row, head), 65.3 GFLOP
// a layer at 64 x 499 (0.066 ms at the bf16 peak) against 262 MB of q, k, v
// and o (0.078 ms at 3.35 TB/s): the two bounds lie close once the scores
// stay on chip (the torch ops took 6.4 ms a layer there).  The exact
// softmax, normalised before P is rounded, needs the row's max and sum
// before any P exists, hence two passes over the row's key tiles:
//   - pass 1 multiplies S = Q.K^T tile by tile and keeps a running max and
//     sum (the sum rescaled by exp(m_old - m_new) when the max grows): the
//     whole row's m and l in f32;
//   - pass 2 multiplies S again, forms P = exp(s - m) / l in registers,
//     rounds it to bf16 and adds P.V into O; O needs no rescale and no final
//     division.
// Pass 2's extra Q.K^T is a third more tensor work than one online pass,
// and buys any T with no score block in shared memory (K of one (row, head)
// is 64 KB at T = 499 and comes back from L2).
// The body is csrc/attention.cu's: one warpgroup (128 threads) owns 64 query
// rows of one (row, head), Q is the A operand of every score product from
// registers, K and V tiles of 64 keys arrive by cp.async into a four-stage
// ring in the 128-byte swizzle, the score accumulator is the softmax's
// working set (row max and sum by shuffles among the four lanes of a row),
// P is packed to bf16 in registers as the A operand of O += P.V, and the
// scores of tile t + 1 are multiplied while tile t's softmax runs.  Three
// blocks an SM.
// The mask: a block first reads its row's T mask bytes once and marks each
// key tile as holding a valid key, a padded key, or both.  Tiles whose keys
// are all padded are not visited when the row has a valid key (their
// probabilities are exactly 0 in f32, exp(-1e9 - m)); a row with no valid key
// visits every tile.  Only a tile that holds a padded key, or the ragged
// last tile (keys past T do not exist: -inf), checks keys one by one.
// Scores stay raw products in registers; the scale is applied inside the
// exponent, 2^((a - m) 0.125 log2 e), and the -1e9 on a score is -8e9 on
// its raw product: scaling by a power of two rounds nothing, so the f32 sum
// s + (-1e9) is the plain route's bit for bit.
#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using mmer::bf16;

constexpr int HD = 64;        // head dim
constexpr int BK = 64;        // keys per tile
constexpr int BQ = 64;        // query rows per block: one warpgroup
constexpr int NTHREAD = 128;
constexpr int MIN_BLOCKS = 3;  // per SM: up to 168 registers a thread
// Ring stages: while tile t is multiplied, tile t + 1 has landed and tile
// t + 2 is in flight; P.V of tile t - 1 may still be reading its V.
constexpr int NSTAGE = 4;
constexpr int TILE_BYTES = 64 * mmer::SW_ROW_BYTES;   // 64 rows of 64 bf16
constexpr int STAGE_BYTES = 2 * TILE_BYTES;           // a K tile and a V tile
constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
constexpr float SCALE = 0.125f;                       // 1 / sqrt(64)
constexpr float KEY_BIAS_RAW = -1e9f / SCALE;         // -8e9, exact in f32
// A key tile's marks, and the flag of a visited tile that checks its keys.
constexpr int TILE_VALID = 1, TILE_PADDED = 2;
constexpr int EDGE = 1 << 30;

size_t smem_bytes(int ntile) {
  return 1024                                    // alignment slack
         + size_t(RING_BYTES)                    // K, V ring
         + 2 * size_t(ntile) * sizeof(int);      // marks and the visit list
}

using mmer::fast_exp2;

// grid (ceil(T / 64), B * heads).  q, k, v: (B, T, heads * 64) bf16 of row
// stride ld; mask: (B, T) bytes or null; o: (B, T, heads * 64) bf16,
// contiguous.
__global__ void __launch_bounds__(NTHREAD, MIN_BLOCKS)
plain_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                       bf16* __restrict__ o, int heads, int t_len, int ld) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int n_visit;
  const uint32_t raw = mmer::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int ntile = (t_len + BK - 1) / BK;
  int* marks = reinterpret_cast<int*>(smem_raw + (ring - raw) + RING_BYTES);
  int* visit = marks + ntile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t head0 = size_t(b) * t_len * ld + size_t(h) * HD;
  const bf16* qb = q + head0;
  const bf16* kb = k + head0;
  const bf16* vb = v + head0;
  const unsigned char* mrow = mask ? mask + size_t(b) * t_len : nullptr;

  // The row's key tiles: marks from the mask, a warp 32 keys at a time.
  for (int i = tid; i < ntile; i += NTHREAD) marks[i] = 0;
  __syncthreads();
  for (int key0 = warp * 32; key0 < t_len; key0 += NTHREAD) {
    const int key = key0 + lane;
    const bool exists = key < t_len;
    const bool padded = exists && mrow != nullptr && mrow[key] != 0;
    const unsigned any_padded = __ballot_sync(0xffffffffu, padded);
    const unsigned any_valid = __ballot_sync(0xffffffffu, exists && !padded);
    if (lane == 0)
      atomicOr(&marks[key0 / BK], (any_valid ? TILE_VALID : 0) | (any_padded ? TILE_PADDED : 0));
  }
  __syncthreads();
  if (tid == 0) {
    bool any = false;
    for (int t = 0; t < ntile; ++t) any |= (marks[t] & TILE_VALID) != 0;
    int n = 0;
    for (int t = 0; t < ntile; ++t) {
      if (any && !(marks[t] & TILE_VALID)) continue;   // every probability exactly 0
      const bool edge = (marks[t] & TILE_PADDED) || (t + 1) * BK > t_len;
      visit[n++] = t | (edge ? EDGE : 0);
    }
    n_visit = n;
  }
  __syncthreads();
  const int nv = n_visit;
  const int nstep = 2 * nv;   // pass 1: steps [0, nv); pass 2: [nv, 2 nv)
  auto tile_of = [&](int j) -> int { return visit[j < nv ? j : j - nv]; };

  // Step j's ring stage holds its K tile and, in pass 2, its V tile.
  auto stage_of = [&](int j) -> uint32_t { return ring + (j % NSTAGE) * STAGE_BYTES; };
  auto start_step = [&](int j) {
    if (j < nstep) {
      const int k0 = (tile_of(j) & ~EDGE) * BK;
      mmer::load_rows<NTHREAD>(stage_of(j), kb, size_t(ld), k0, t_len, tid);
      if (j >= nv)
        mmer::load_rows<NTHREAD>(stage_of(j) + TILE_BYTES, vb, size_t(ld), k0, t_len, tid);
    }
    mmer::cp_async_commit();
  };
  start_step(0);
  start_step(1);

  // Q as the A operand of every score product: this lane's fragment of the
  // block's 64 rows, rows past T as zeros.
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * quad;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qb + size_t(row0) * ld + c);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qb + size_t(row1) * ld + c);
    qf[kk][0] = row0 < t_len ? r0[0] : 0u;
    qf[kk][1] = row1 < t_len ? r1[0] : 0u;
    qf[kk][2] = row0 < t_len ? r0[4] : 0u;
    qf[kk][3] = row1 < t_len ? r1[4] : 0u;
  }

  const float c_log2 = SCALE * 1.4426950408889634f;   // raw product -> log2 units
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  // The max of this lane's two rows (raw products; the same in the four
  // lanes of a row) and this lane's share of their sums; from pass 2 on,
  // l_run holds the rows' 1 / l.
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  // Scores of step j's tile into ``acc``: (64 x 64) = Q (64 x 64) . K_tile^T;
  // the first k-step overwrites the accumulator.  One commit group.
  auto start_scores = [&](int j, float (&acc)[32]) {
    const uint32_t k_tile = stage_of(j);
    mmer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mmer::wgmma_m64n64k16_rs<0>(acc, qf[kk], mmer::wgmma_desc(k_tile + kk * 32), kk > 0);
    mmer::wgmma_commit();
  };

  // One step.  ``sacc`` is receiving step j's scores, ``snext`` takes step
  // j + 1's (started before this step's softmax, so that the tensor cores
  // work through it); in pass 2 ``pf`` takes this tile's P while the
  // previous tile's P.V, which reads the other P buffer, may still run.
  auto step = [&](int j, float (&sacc)[32], float (&snext)[32], uint32_t (&pf)[4][4]) {
    // In flight, oldest first: pass 1 S(j); pass 2 P.V(j - 2), S(j),
    // P.V(j - 1).  Waiting here, before the barrier, also retires P.V(j - 2),
    // whose V stage the copy below overwrites.
    if (j > nv) mmer::wgmma_wait<1>();
    else mmer::wgmma_wait<0>();
    mmer::cp_async_wait<0>();
    mmer::fence_proxy_async();
    __syncthreads();   // tile j + 1 has landed; every thread is done with step j - 2
    start_step(j + 2);
    if (j == 0) {
      start_scores(0, sacc);
      mmer::wgmma_wait<0>();
    }
    mmer::wgmma_fence_operand(sacc);
    if (j + 1 < nstep) start_scores(j + 1, snext);

    const int tile = tile_of(j);
    if (tile & EDGE) {
      const int k0 = (tile & ~EDGE) * BK;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        if (key >= t_len) sacc[i] = -CUDART_INF_F;
        else if (mrow != nullptr && mrow[key]) sacc[i] += KEY_BIAS_RAW;
      }
    }

    // Element i of the accumulator belongs to this lane's row (i >> 1) & 1.
    if (j < nv) {
      // Pass 1: the running max and sum.  The difference is taken before
      // the multiply: exact where a score equals the max, whatever its size.
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        l_run[r] *= fast_exp2((m_run[r] - m_new) * c_log2);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        l_run[r] += fast_exp2((sacc[i] - m_run[r]) * c_log2);
      }
      return;
    }
    if (j == nv) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        l_run[r] = 1.0f / l_run[r];
      }
    }
    // Pass 2: P normalised in f32, rounded to bf16 and packed pair by pair
    // into the A fragments of O += P.V.
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      pf[i >> 3][(i >> 1) & 3] =
          mmer::pack_bf16(fast_exp2((sacc[i] - m_run[r]) * c_log2) * l_run[r],
                          fast_exp2((sacc[i + 1] - m_run[r]) * c_log2) * l_run[r]);
    }
    const uint32_t v_tile = stage_of(j) + TILE_BYTES;
    mmer::wgmma_fence_operand(oacc);
    mmer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mmer::wgmma_m64n64k16_rs<1>(oacc, pf[kk],
                                  mmer::wgmma_desc(v_tile + kk * 16 * mmer::SW_ROW_BYTES), 1);
    mmer::wgmma_commit();
  };

  // Two steps a trip, so that the two score accumulators and the two P
  // buffers are named at compile time (nstep is even).
  float s_even[32], s_odd[32];
  uint32_t p_even[4][4], p_odd[4][4];
  for (int j = 0; j < nstep; j += 2) {
    step(j, s_even, s_odd, p_even);
    step(j + 1, s_odd, s_even, p_odd);
  }
  mmer::cp_async_wait<0>();
  mmer::wgmma_wait<0>();
  mmer::wgmma_fence_operand(oacc);

  bf16* ob = o + size_t(b) * t_len * heads * HD + size_t(h) * HD;
  const size_t ld_o = size_t(heads) * HD;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = (i >> 1) & 1 ? row1 : row0;
    if (row < t_len)
      *reinterpret_cast<uint32_t*>(ob + size_t(row) * ld_o + 8 * (i >> 2) + 2 * quad) =
          mmer::pack_bf16(oacc[i], oacc[i + 1]);
  }
}

}  // namespace

// q, k, v: (b, t_len, heads * 64) bf16 sharing the row stride ld (elements,
// a multiple of 8; batch stride t_len * ld), 16-byte aligned; mask: (b,
// t_len) bytes, nonzero on padded frames, or null; o: contiguous (b, t_len,
// heads * 64) bf16.
MMER_EXPORT int mmer_plain_attention(const void* q, const void* k, const void* v,
                                     const void* mask, void* o, int b, int heads, int t_len,
                                     int ld, void* stream) {
  if (b <= 0 || heads <= 0 || t_len <= 0 || ld < heads * HD || ld % 8 != 0 ||
      size_t(b) * heads > 65535u)
    return int(cudaErrorInvalidValue);
  const int ntile = (t_len + BK - 1) / BK;
  const size_t smem = smem_bytes(ntile);
  cudaError_t err = cudaFuncSetAttribute(plain_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(ntile, b * heads);
  plain_attention_kernel<<<grid, NTHREAD, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), static_cast<bf16*>(o), heads, t_len, ld);
  return int(cudaGetLastError());
}
