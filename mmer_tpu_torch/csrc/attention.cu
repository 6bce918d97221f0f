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
// so it is compute bound once the (S, S) score matrix stays on chip.  The
// online softmax keeps it there; what the design then has to do is keep the
// tensor cores fed, and an earlier WMMA body that passed the score, P and
// output tiles through shared memory on every key tile reached 4 % of the
// bf16 peak.  This body keeps them in registers:
//   - one warpgroup (4 warps) owns 64 query rows.  S = Q.K^T is one batch of
//     wgmma m64n64k16 with Q as the A operand from registers (loaded once
//     from device memory in the fragment layout: 16 registers a thread) and
//     the K tile as a K-major B operand from shared memory.  The score
//     accumulator is the softmax's working set: row max and row sum are
//     reduced with shuffles among the four lanes that share a row, P is
//     rounded and packed to bf16 in registers and is the A operand of
//     O += P.V from registers (V tile: an MN-major B operand, the transpose
//     bit set), and O is rescaled by alpha in registers.  Shared memory holds
//     K and V tiles and nothing else;
//   - the two products of a warpgroup overlap its softmax: the scores of tile
//     t + 1 are started before the softmax of tile t, and P.V of tile t is
//     waited for only where tile t + 1 rescales O (two score accumulators and
//     two P buffers, named at compile time by taking two tiles a loop trip);
//   - one warpgroup a block (64 query rows, 128 threads, up to 168 registers),
//     three blocks an SM, rather than two warpgroups behind one barrier:
//     measured, a 128-row block whose warpgroups share each K/V tile is
//     slower (one block an SM at this register count), and the blocks of
//     one head run together, so their K/V tiles come from L2.  At the
//     Wav2Vec2 lengths (S = 199..499) 64-row blocks are 78-97 % full;
//   - K/V tiles of 64 keys arrive by 16-byte cp.async into a four-stage ring
//     in the 128-byte swizzle wgmma reads (wgmma.cuh): while tile t is
//     multiplied, tile t + 1 has landed and tile t + 2 is in flight; rows that
//     do not exist are zero-filled by the copy's zero-size form, so the last
//     tile of a head never reads the next head's rows;
//   - the mask touches the accumulator only on the tiles that need it, the
//     ragged last tile and (key lengths) the tile that holds len; interior
//     tiles carry no bounds check.  The scale is applied inside the exponent,
//     2^(c (s - m)) with c = scale log2(e), on the special-function unit.
// Q as a register operand rather than a resident shared tile: an m64n64k16
// with both operands in shared memory reads 4 KB for 32 cycles of tensor work,
// the whole of the SM's shared-memory rate; from registers it reads 2 KB.
// The TPU tiling (BQ = 416, six heads per program, the ones column in V)
// answered the TPU's per-program overhead and does not carry over.
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
//                 as an MN-major B operand (one bit of the instruction);
//   depth         DQK = 80: q and k carry a 65th column (ones / 0 or -1e9 on
//                 padded keys) that folds the key mask into the first product,
//                 zero-padded to a multiple of the 16-deep wgmma step (five
//                 k-steps instead of four).
// Keys in [S, S_pad) are zero rows: K and V tiles are zero-filled past the
// rows that exist in memory, so no padded copy of k or v is needed (the
// 65-column K, whose padded rows hold the bias, is materialised by its
// caller).  Padded query rows are never loaded into a result nor written.
#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using mmer::bf16;

constexpr int HD = 64;        // head dim
constexpr int BK = 64;        // keys per tile
constexpr int BQ = 64;        // query rows per block: one warpgroup
constexpr int NTHREAD = 128;
constexpr int MIN_BLOCKS = 3;  // per SM: 168 registers a thread
// Ring stages: while tile t is multiplied, tile t + 1 has landed (its scores
// are already being computed), tile t + 2 is in flight, and the products on
// tile t - 1's values may still be running.
constexpr int NSTAGE = 4;
constexpr int TILE_BYTES = 64 * mmer::SW_ROW_BYTES;   // 64 rows of 64 bf16

enum Softmax { SOFTMAX_MASKED = 0, SOFTMAX_NOMASK = 1, SHIFT_ONLY = 2, PRODUCTS_ONLY = 3 };

// A K tile of depth 80 is two swizzled tiles: depth 0..63 and 64..79.
template <int DQK>
constexpr int K_TILE_BYTES = (DQK > 64 ? 2 : 1) * TILE_BYTES;

template <int DQK>
constexpr size_t smem_bytes() {
  return 1024                                                   // alignment slack
         + size_t(NSTAGE) * (K_TILE_BYTES<DQK> + TILE_BYTES)  // K, V ring
         + HD * sizeof(float);                                  // column sums of a V tile
}

constexpr float KEY_BIAS = -1e9f;  // on keys in [len, S)

// 2^x on the special-function unit (2 ulp; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 64 rows x 64 bf16 (8 chunks of 16 bytes a row) from rows [row0, row0 + 64) of
// a matrix of row stride ``ld`` into a swizzled tile; rows at or past ``rows``
// are zero-filled.  Copy j of a thread is NTHREAD chunks after copy j - 1: a
// fixed number of rows down, in the same chunk column and swizzle phase.
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, size_t ld, int row0,
                                          int rows, int tid) {
  constexpr int STEP = NTHREAD / 8;      // rows between a thread's copies
  const int r = tid >> 3, c = tid & 7;
  const uint32_t to = dst + mmer::sw128(r, c);
  const bf16* from = src + size_t(row0 + r) * ld + c * 8;
#pragma unroll
  for (int j = 0; j < 64 / STEP; ++j) {
    const bool valid = row0 + r + j * STEP < rows;
    mmer::cp_async_16(to + j * STEP * mmer::SW_ROW_BYTES, valid ? from + size_t(j) * STEP * ld : src,
                      valid);
  }
}

// Start the copies of key tile [k0, k0 + 64) into one ring stage: K rows (or,
// KT, the 64 depth rows of the pre-transposed K) and V rows; rows that do
// not exist in memory are zero-filled.
template <bool KT, int DQK>
__device__ __forceinline__ void load_kv_tile(uint32_t k_dst, uint32_t v_dst, const bf16* kb,
                                             const bf16* vb, int k0, int k_rows, int s,
                                             int tid) {
  if constexpr (KT) {
    load_rows(k_dst, kb + k0, size_t(k_rows), 0, HD, tid);      // columns [k0, k0 + 64)
  } else if constexpr (DQK == HD) {
    load_rows(k_dst, kb, HD, k0, k_rows, tid);
  } else {
    constexpr int CH = DQK / 8;   // 16-byte chunks per K row
    for (int i = tid; i < BK * CH; i += NTHREAD) {
      const int r = i / CH, c = i % CH;
      const bool valid = k0 + r < k_rows;
      const bf16* src = valid ? kb + size_t(k0 + r) * DQK + c * 8 : kb;
      const uint32_t dst = c < 8 ? k_dst + mmer::sw128(r, c)
                                 : k_dst + TILE_BYTES + mmer::sw128(r, c - 8);
      mmer::cp_async_16(dst, src, valid);
    }
  }
  load_rows(v_dst, vb, HD, k0, s, tid);
}

// q: (bh, s, DQK); k: (bh, k_rows, DQK), or (bh, 64, k_rows) when KT; v, o:
// (bh, s, 64).  Keys [0, s_keys) are visited; k rows >= k_rows and v rows >= s
// read as zero.
template <bool VARLEN, int SM, bool KT, int DQK>
__global__ void __launch_bounds__(NTHREAD, MIN_BLOCKS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ lens, int heads, int s, int s_keys, int k_rows,
                 float scale) {
  static_assert(!KT || DQK == HD, "the transposed K layout has depth 64");
  constexpr int KSTEPS = DQK / 16;
  constexpr int STAGE_BYTES = K_TILE_BYTES<DQK> + TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = mmer::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* vsum = reinterpret_cast<float*>(smem_raw + (ring - raw) + NSTAGE * STAGE_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const size_t base = size_t(blockIdx.y) * s * HD;
  const bf16* qb = q + size_t(blockIdx.y) * s * DQK;
  const bf16* kb = k + size_t(blockIdx.y) * k_rows * DQK;
  const bf16* vb = v + base;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const int len = VARLEN ? min(lens[blockIdx.y / heads], s) : s_keys;
  const int kend = len > 0 ? len : s_keys;
  const int ntile = (kend + BK - 1) / BK;

  auto stage_of = [&](int t) -> uint32_t { return ring + (t % NSTAGE) * STAGE_BYTES; };
  auto start_tile = [&](int t) {
    if (t < ntile)
      load_kv_tile<KT, DQK>(stage_of(t), stage_of(t) + K_TILE_BYTES<DQK>, kb, vb, t * BK, k_rows,
                            s, tid);
    mmer::cp_async_commit();
  };
  start_tile(0);
  start_tile(1);

  // Q as the A operand of every score product: this lane's fragment of the
  // block's 64 rows, rows past S as zeros.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * quad;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qb + size_t(row0) * DQK + c);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qb + size_t(row1) * DQK + c);
    qf[kk][0] = row0 < s ? r0[0] : 0u;
    qf[kk][1] = row1 < s ? r1[0] : 0u;
    qf[kk][2] = row0 < s ? r0[4] : 0u;
    qf[kk][3] = row1 < s ? r1[4] : 0u;
  }

  const float scale_log2 = scale * 1.4426950408889634f;
  const float key_bias_raw = KEY_BIAS / scale;   // -1e9 after the scale
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  // Running max (of the raw products) and this lane's share of the running
  // sum of its two rows.
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  float vrun[SM == SHIFT_ONLY ? 16 : 1];   // column sums of the V rows so far
  float n_prev = 0.f;                      // keys this lane has summed per row
  if constexpr (SM == SHIFT_ONLY) {
#pragma unroll
    for (int j = 0; j < 16; ++j) vrun[j] = 0.f;
  }

  // Scores of tile t into ``acc``: (64 x 64) = Q (64 x DQK) . K_tile^T; the
  // first k-step overwrites the accumulator.  Asynchronous: one commit group.
  auto start_scores = [&](int t, float (&acc)[32]) {
    const uint32_t k_tile = stage_of(t);
    mmer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // K-major: 32 bytes along the row per k-step, the depth past 64 in the
      // second tile; pre-transposed (MN-major): 16 rows down per k-step.
      const uint32_t at = KT ? k_tile + kk * 16 * mmer::SW_ROW_BYTES
                             : (kk < 4 ? k_tile + kk * 32 : k_tile + TILE_BYTES + (kk - 4) * 32);
      mmer::wgmma_m64n64k16_rs<KT ? 1 : 0>(acc, qf[kk], mmer::wgmma_desc(at), kk > 0);
    }
    mmer::wgmma_commit();
  };

  // One key tile.  ``sacc`` holds (or is receiving) its scores, ``snext``
  // takes the next tile's, started before this tile's softmax so that the
  // tensor cores work through it; ``pf`` takes this tile's P, while the
  // previous tile's P.V, which reads the other P buffer and writes O, may
  // still be running: it is waited for only where O is rescaled.
  auto tile_step = [&](int t, float (&sacc)[32], float (&snext)[32], uint32_t (&pf)[4][4]) {
    const int k0 = t * BK;
    mmer::cp_async_wait<0>();
    mmer::fence_proxy_async();
    __syncthreads();   // tile t + 1 has landed; every warp is done with tile t - 2
    start_tile(t + 2);
    if constexpr (SM == SHIFT_ONLY) {
      if (tid < HD) {
        const unsigned char* vt = smem_raw + (stage_of(t) + K_TILE_BYTES<DQK> - raw);
        float acc = 0.f;
        for (int r = 0; r < BK; ++r)
          acc += __bfloat162float(*reinterpret_cast<const bf16*>(
              vt + mmer::sw128(r, tid >> 3) + (tid & 7) * 2));
        vsum[tid] = acc;
      }
      __syncthreads();
    }

    // In flight, oldest first: S(t), then P.V(t - 1).
    if (t == 0) {
      start_scores(0, sacc);
      mmer::wgmma_wait<0>();
    } else {
      mmer::wgmma_wait<1>();
    }
    mmer::wgmma_fence_operand(sacc);
    const bool more = t + 1 < ntile;
    if (more) start_scores(t + 1, snext);      // in flight: P.V(t - 1), S(t + 1)

    // The accumulator holds raw products; the scale (> 0) is applied inside
    // the exponent, exp(scale (s - m)) = 2^(c (s - m)) with c = scale log2(e).
    // The mask works on raw products too: only the ragged last tile and the
    // tile that holds len need it.
    if constexpr (SM == SOFTMAX_MASKED) {
      if (k0 + BK > s_keys || (VARLEN && k0 + BK > len)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          if (key >= s_keys) sacc[i] = -CUDART_INF_F;
          else if (VARLEN && key >= len) sacc[i] += key_bias_raw;
        }
      }
    }

    // Online softmax in registers; element i of the accumulator belongs to
    // this lane's row (i >> 1) & 1.  P is rounded to bf16 and packed pair by
    // pair into the A fragments of the second product.
    float sum[2] = {0.f, 0.f};
    auto round_pair = [&](int i, float p0, float p1) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(p0, p1);
      const float2 back = __bfloat1622float2(p);
      sum[(i >> 1) & 1] += back.x + back.y;
      pf[i >> 3][(i >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&p);
    };
    // Everything that touches O waits for P.V(t - 1); S(t + 1) stays in flight.
    auto previous_values_done = [&]() {
      if (more) mmer::wgmma_wait<1>();
      else mmer::wgmma_wait<0>();
      mmer::wgmma_fence_operand(oacc);
    };
    if constexpr (SM == PRODUCTS_ONLY) {
      // p = score: nothing but the rounding between the two products.
#pragma unroll
      for (int i = 0; i < 32; i += 2) round_pair(i, sacc[i] * scale, sacc[i + 1] * scale);
      l_run[0] += sum[0];
      l_run[1] += sum[1];
      previous_values_done();
    } else {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      float m_new[2];      // of the raw products
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m_run[r], mx[r]);
      }
      if constexpr (SM == SHIFT_ONLY) {
        // p = score - max.  Rows summed so far were shifted by the old max:
        // move them to the new one.
        const float delta[2] = {t == 0 ? 0.f : (m_new[0] - m_run[0]) * scale,
                                t == 0 ? 0.f : (m_new[1] - m_run[1]) * scale};
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float m = m_new[(i >> 1) & 1];
          round_pair(i, (sacc[i] - m) * scale, (sacc[i + 1] - m) * scale);
        }
        previous_values_done();
#pragma unroll
        for (int i = 0; i < 32; ++i)
          oacc[i] -= delta[(i >> 1) & 1] * vrun[2 * (i >> 2) + (i & 1)];
#pragma unroll
        for (int j = 0; j < 16; ++j) vrun[j] += vsum[8 * (j >> 1) + 2 * quad + (j & 1)];
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] - delta[r] * n_prev + sum[r];
        n_prev += float(BK / 4);
      } else {
        // The difference is taken before the multiply: exact when a score
        // equals the max, whatever their size (rows with every key at -1e9).
        const float alpha[2] = {fast_exp2((m_run[0] - m_new[0]) * scale_log2),
                                fast_exp2((m_run[1] - m_new[1]) * scale_log2)};
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float m = m_new[(i >> 1) & 1];
          round_pair(i, fast_exp2((sacc[i] - m) * scale_log2),
                     fast_exp2((sacc[i + 1] - m) * scale_log2));
        }
        previous_values_done();
#pragma unroll
        for (int i = 0; i < 32; ++i) oacc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
      }
      m_run[0] = m_new[0];
      m_run[1] = m_new[1];
    }

    // O (64 x 64) += P (64 x 64 keys, registers) . V_tile (64 keys x 64).
    const uint32_t v_tile = stage_of(t) + K_TILE_BYTES<DQK>;
    mmer::wgmma_fence_operand(oacc);
    mmer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mmer::wgmma_m64n64k16_rs<1>(oacc, pf[kk],
                                  mmer::wgmma_desc(v_tile + kk * 16 * mmer::SW_ROW_BYTES), 1);
    mmer::wgmma_commit();                      // in flight: S(t + 1), P.V(t)
  };

  // Two tiles a trip, so that the two score accumulators and the two P
  // buffers are named at compile time.
  float s_even[32], s_odd[32];
  uint32_t p_even[4][4], p_odd[4][4];
  for (int t = 0; t < ntile; t += 2) {
    tile_step(t, s_even, s_odd, p_even);
    if (t + 1 < ntile) tile_step(t + 1, s_odd, s_even, p_odd);
  }
  mmer::cp_async_wait<0>();
  mmer::wgmma_wait<0>();
  mmer::wgmma_fence_operand(oacc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1, row = r ? row1 : row0;
    if (row < s)
      *reinterpret_cast<__nv_bfloat162*>(o + base + size_t(row) * HD + 8 * (i >> 2) + 2 * quad) =
          __floats2bfloat162_rn(oacc[i] * inv[r], oacc[i + 1] * inv[r]);
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
