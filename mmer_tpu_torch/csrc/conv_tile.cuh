// The shared body of the Wav2Vec2 conv-encoder kernels: one VALID conv layer
// with C = 512 output channels as a GEMM over im2col rows, then the Pallas
// _epilogue (mmer_tpu/ops/conv_pyramid.py:80) from registers.  Used by
// conv_encoder.cu (the whole-pyramid route's kernel-3 and kernel-2 layers) and
// conv_layers.cu (the per-layer route's kernel-3 layers, and its rows . W
// layers of K >= 64).  The layer-0 kernels of both routes run on the CUDA
// cores and share this file's lane_bias_ln_gelu_store only.  sm_90a only.
//
// The operand.  Im2col row t of a stride-s conv over a (T_in, C_in) activation
// is the k*C_in contiguous values that start at s*t*C_in: for a kernel-3
// stride-2 layer, merged row t of the (T_in/2, 2C) view and the first C
// values of merged row t + 1.  So no patch matrix exists anywhere: row t of
// the A operand is a pointer and a length.  Every layer that reaches this
// body is such a layer (stride 2, 512 channels in: ROW_STRIDE), so its row
// step and the weight's row length are constants.  Copies at or beyond the end of
// the clip's own array, and rows the block does not compute, are zero-filled
// (cp.async with no source bytes), never read from the next clip.
//
// The block.  64 output rows (one wgmma M) and all 512 channels, 256 threads:
// two warpgroups, each the owner of 256 channels as a 64 x 256 f32
// accumulator in registers (128 a thread).  A (64 x 512) f32 accumulator is
// half of the SM's register file, so one block an SM.  K walks in steps of 64:
// each step stages the A tile (64 rows x 64 k, 8 KB) and the B tile (512
// channels x 64 k, 64 KB) by 16-byte cp.async in the 128-byte swizzle
// (wgmma.cuh) into a ring of three stages, and every warpgroup starts four
// m64n256k16 products from shared memory.  A step's products stay in flight
// while the previous step's stage is handed back and refilled, two steps
// ahead of the one being multiplied.  The B tile is K-major (a (512, K)
// weight, conv_encoder.cu) or MN-major (a (K, 512) weight, conv_layers.cu:
// the transpose bit, four 64-wide column blocks per product).
//
// What bounds it.  A step moves 72 KB from L2 into the SM for 4.2 MFLOP, 57
// FLOP a staged byte: at the tensor cores' 989 TFLOP/s the 132 SMs would pull
// 17 TB/s from L2, several times what it delivers.  So L2 bandwidth, not the
// tensor cores, sets this body's ceiling; 128-row tiles shared by a cluster
// pair (85 FLOP a byte, 102 with a multicast A tile) are the next step.
//
// The epilogue.  Accumulator layout (wgmma.cuh): warp w of warpgroup g holds
// rows 16(w%4) + lane/4 and + 8; acc[4j + 0, 1] and acc[4j + 2, 3] are
// channels 256g + 8j + 2(lane%4), + 1 of those two rows.  Each thread rounds
// its sums and adds the bias in bf16, two channels to a bf16 pair; the four
// lanes of a quad then trade pairs (three shuffles for each two groups of 8
// channels) so that lane q holds eight consecutive channels of one row, row
// 16(w%4) + lane/4 + 8(q%2), in 16 of the 32 groups: 64 registers of bf16
// pairs, never 128 f32 values beside the epilogue's temporaries.  A lane sums
// its row's values, the lane of the quad with the same row adds its sums (one
// shuffle), and the two warpgroups trade them through 1 KB of shared memory,
// adding in a fixed order (channels 0-255, then 256-511).  LayerNorm and GELU
// follow with the _epilogue's roundings (those of lane_bias_ln_gelu_store below),
// eight channels at a time, each group one 16-byte store.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace mmer {
namespace conv {

constexpr int C = 512;                                // output channels
constexpr int BM = 64;                                // output rows a block
constexpr int KC = 64;                                // K a step
constexpr int ROW_STRIDE = 2 * C;                     // im2col row step: stride 2 over C
constexpr int NTHREAD = 256;                          // two warpgroups
constexpr int NSTAGE = 3;
constexpr int A_BYTES = BM * SW_ROW_BYTES;            // 8 KB
constexpr int B_BYTES = C * SW_ROW_BYTES;             // 64 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int MN_BLOCK_BYTES = KC * SW_ROW_BYTES;     // 64 k rows x 64 channels
constexpr int STATS_BYTES = 2 * BM * 8;               // (sum, sum of squares) a row and warpgroup
constexpr int VEC_BYTES = 3 * C * 4;                  // conv bias, LayerNorm weight and bias
constexpr size_t SMEM_BYTES =
    1024 + size_t(NSTAGE) * STAGE_BYTES + STATS_BYTES + VEC_BYTES;
static_assert(SMEM_BYTES <= 232448, "shared memory a block can use");

// Start the copies of K step ``k0`` of the A tile: rows t0 .. t0 + 63, row t
// the values at a + t * ROW_STRIDE; a copy is zero-filled at or beyond
// ``limit`` (the clip's own array) or for a row at or beyond t_rows.
__device__ __forceinline__ void load_a_tile(uint32_t dst, const bf16* a, int limit, int t0,
                                            int t_rows, int k0, int tid) {
#pragma unroll
  for (int j = 0; j < BM * 8 / NTHREAD; ++j) {
    const int r = (tid >> 3) + j * (NTHREAD / 8), c = tid & 7;
    const int idx = (t0 + r) * ROW_STRIDE + k0 + c * 8;
    const bool valid = t0 + r < t_rows && idx < limit;
    cp_async_16(dst + sw128(r, c), a + (valid ? idx : 0), valid);
  }
}

// K step ``k0`` of an A tile whose row t is row t of a (rows, kdim) matrix
// ``a``: the kdim values at a + t * kdim.  A copy is zero-filled at or beyond
// ``limit`` (the clip's own array), at or beyond column kdim (a K that is not
// a multiple of KC fills its last step with zeros), or for a row at or
// beyond t_rows.
__device__ __forceinline__ void load_a_rows(uint32_t dst, const bf16* a, int limit, int kdim,
                                            int t0, int t_rows, int k0, int tid) {
#pragma unroll
  for (int j = 0; j < BM * 8 / NTHREAD; ++j) {
    const int r = (tid >> 3) + j * (NTHREAD / 8), col = k0 + (tid & 7) * 8;
    const int idx = (t0 + r) * kdim + col;
    const bool valid = t0 + r < t_rows && col < kdim && idx < limit;
    cp_async_16(dst + sw128(r, tid & 7), a + (valid ? idx : 0), valid);
  }
}

// K step ``k0`` of a K-major weight (C rows of KP values, row n channel n's
// K): C rows of 64 k.  Copy j of a thread is 32 rows below copy j - 1, in
// the same swizzle phase.
template <int KP>
__device__ __forceinline__ void load_b_kmajor(uint32_t dst, const bf16* w, int k0, int tid) {
  const int row = tid >> 3, c = tid & 7;
  const bf16* src = w + row * KP + k0 + c * 8;
  const uint32_t to = dst + sw128(row, c);
#pragma unroll
  for (int j = 0; j < C * 8 / NTHREAD; ++j)
    cp_async_16(to + j * (NTHREAD / 8) * SW_ROW_BYTES, src + j * (NTHREAD / 8) * KP, true);
}

// K step ``k0`` of an MN-major weight (K rows of C values): C / 64 column
// blocks of (64 k rows x 64 channels), MN_BLOCK_BYTES apart.  Copy j of a
// thread is 4 k rows below copy j - 1.  With RAGGED, k rows at or beyond
// ``k_rows`` are zero-filled (a K that is not a multiple of KC).
template <bool RAGGED = false>
__device__ __forceinline__ void load_b_mnmajor(uint32_t dst, const bf16* w, int k0, int tid,
                                               int k_rows = 0) {
  const int row = tid >> 6, cn = tid & 63;
  const bf16* src = w + (k0 + row) * C + cn * 8;
  const uint32_t to = dst + (cn >> 3) * MN_BLOCK_BYTES;
#pragma unroll
  for (int j = 0; j < KC * (C / 8) / NTHREAD; ++j) {
    const bool valid = !RAGGED || k0 + row + 4 * j < k_rows;
    cp_async_16(to + sw128(row + 4 * j, cn & 7), valid ? src + j * 4 * C : w, valid);
  }
}

// acc (this warpgroup's 64 x 256 f32) = A . B over ``nstep`` K steps: the A
// and B tiles of step s copied into a stage by ``load_a(stage_address, s)``
// and ``load_b(stage_address, s)``; TRANS_B as load_b lays B out (0: K-major,
// 1: MN-major).  Every thread of the block takes part; nothing is in flight
// on return.
template <int TRANS_B, typename LoadA, typename LoadB>
__device__ __forceinline__ void mainloop_steps(float (&acc)[128], uint32_t ring, int nstep,
                                               LoadA&& load_a, LoadB&& load_b, int tid) {
  const int wg = tid >> 7;
  auto start_copy = [&](int step) {
    if (step < nstep) {
      const uint32_t stage = ring + (step % NSTAGE) * STAGE_BYTES;
      load_a(stage, step);
      load_b(stage + A_BYTES, step);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) start_copy(s);
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int step = 0; step < nstep; ++step) {
    cp_async_wait<NSTAGE - 2>();      // this step's tiles have landed ...
    fence_proxy_async();
    __syncthreads();                  // ... for every thread, visible to wgmma
    const uint32_t a_tile = ring + (step % NSTAGE) * STAGE_BYTES;
    const uint32_t b_tile = a_tile + A_BYTES;
    wgmma_fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t desc_b =
          TRANS_B ? wgmma_desc_mn(b_tile + wg * 4 * MN_BLOCK_BYTES + kk * 16 * SW_ROW_BYTES,
                                  MN_BLOCK_BYTES)
                  : wgmma_desc(b_tile + wg * (C / 2) * SW_ROW_BYTES + kk * 32);
      wgmma_m64n256k16_ss<TRANS_B>(acc, wgmma_desc(a_tile + kk * 32), desc_b, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // the previous step's products are complete ...
    __syncthreads();                  // ... in both warpgroups: its stage is free
    start_copy(step + NSTAGE - 1);
  }
  wgmma_wait<0>();
  wgmma_fence_operand(acc);
}

// mainloop_steps over NSTEP steps of an im2col A tile (load_a_tile).
template <int TRANS_B, int NSTEP, typename LoadB>
__device__ __forceinline__ void mainloop(float (&acc)[128], uint32_t ring, const bf16* a,
                                         int limit, int t0, int t_rows, LoadB&& load_b,
                                         int tid) {
  mainloop_steps<TRANS_B>(
      acc, ring, NSTEP,
      [&](uint32_t dst, int step) { load_a_tile(dst, a, limit, t0, t_rows, step * KC, tid); },
      load_b, tid);
}

// A block's shared memory (SMEM_BYTES of dynamic shared memory): the ring,
// aligned to 1024 bytes for the swizzle, then the row statistics, then the
// epilogue's vectors.
struct Shared {
  uint32_t ring;
  float2* stats;
  float* vs;
};
__device__ __forceinline__ Shared carve(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float2* stats = reinterpret_cast<float2*>(smem_raw + (ring - raw) + NSTAGE * STAGE_BYTES);
  return {ring, stats, reinterpret_cast<float*>(stats + 2 * BM)};
}

// The grid over ``t_rows`` output rows of ``batch`` clips: a block for each 64
// rows of each clip (grid y the clip).
inline dim3 grid_of(int t_rows, int batch) { return dim3((t_rows + BM - 1) / BM, batch); }

// Launch a kernel of this body on grid_of(t_rows, batch).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kern, int t_rows, int batch, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kern<<<grid_of(t_rows, batch), NTHREAD, SMEM_BYTES, stream>>>(args...);
  return cudaGetLastError();
}

// The epilogue's three (C,) vectors into shared memory, [cb | ln_w | ln_b];
// read after the block's next barrier.
__device__ __forceinline__ void stage_vectors(float* vs, const float* __restrict__ cb,
                                              const float* __restrict__ ln_w,
                                              const float* __restrict__ ln_b, int tid) {
  for (int i = tid; i < C; i += NTHREAD) {
    vs[i] = cb[i];
    vs[C + i] = ln_w[i];
    vs[2 * C + i] = ln_b[i];
  }
}

// The _epilogue on the block's accumulators (layout in the note above): f32
// sums rounded to bf16, the bias added in bf16, LayerNorm in f32 (flax: eps
// 1e-6, var = max(0, E[x^2] - E[x]^2)) rounded to bf16, exact-erf GELU in f32
// rounded to bf16.  Row t0 + r is stored into ``out`` (rows of C bf16) if it
// is below t_rows.  ``stats`` is STATS_BYTES of shared memory, ``vs`` the
// vectors of stage_vectors.
__device__ __forceinline__ void bias_ln_gelu_store(float (&acc)[128], float2* stats,
                                                   const float* vs, bf16* __restrict__ out,
                                                   int t0, int t_rows, int tid) {
  const int wg = tid >> 7, lane = tid & 31, quad = lane & 3;
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int row = r0 + 8 * (quad & 1);                 // this lane's row after the trade
  const int col0 = wg * (C / 2) + 2 * quad;
  // y[4b + d]: channels 8j + 2d, + 1 of ``row``, j = 2b + quad / 2 (of this
  // warpgroup's 256).
  uint32_t y[64];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    // Item i (row r0 + 8 (i & 1), group 2b + (i >> 1)) is spread over the
    // quad, a bf16 pair a lane.
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, j = 2 * b + (i >> 1);
      const float2 cb = *reinterpret_cast<const float2*>(vs + col0 + 8 * j);
      v[i] = pack_bf16(round_bf16(round_bf16(acc[4 * j + 2 * h]) + round_bf16(cb.x)),
                       round_bf16(round_bf16(acc[4 * j + 2 * h + 1]) + round_bf16(cb.y)));
    }
    // r[d]: lane (quad ^ d)'s pair of item quad, channels 8j + 2 (quad ^ d), + 1.
    uint32_t r[4];
    r[0] = pick4(v, quad);
#pragma unroll
    for (int d = 1; d < 4; ++d) r[d] = __shfl_xor_sync(0xffffffffu, pick4(v, quad ^ d), d);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint32_t u = pick4(r, quad ^ d);
      const float a0 = lo_bf16(u), a1 = hi_bf16(u);
      s += a0;
      ss += a0 * a0;
      s += a1;
      ss += a1 * a1;
      y[4 * b + d] = u;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  if (quad < 2) stats[wg * BM + row] = make_float2(s, ss);
  __syncthreads();
  const float2 lo = stats[row], hi = stats[BM + row];
  const float mean = (lo.x + hi.x) / C;
  const float var = fmaxf((lo.y + hi.y) / C - mean * mean, 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-6f);

  bf16* dst = out + size_t(t0 + row) * C + wg * (C / 2) + 8 * (quad >> 1);
  const float4* w4 = reinterpret_cast<const float4*>(vs + C + wg * (C / 2) + 8 * (quad >> 1));
  const float4* b4 = reinterpret_cast<const float4*>(vs + 2 * C + wg * (C / 2) + 8 * (quad >> 1));
  const bool store = t0 + row < t_rows;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const float4 wa = w4[4 * b], wb = w4[4 * b + 1], ba = b4[4 * b], bb = b4[4 * b + 1];
    const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float bias[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    uint32_t o[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint32_t u = y[4 * b + d];
      const float g0 =
          gelu_erf(round_bf16((lo_bf16(u) - mean) * rstd * w[2 * d] + bias[2 * d]));
      const float g1 =
          gelu_erf(round_bf16((hi_bf16(u) - mean) * rstd * w[2 * d + 1] + bias[2 * d + 1]));
      o[d] = pack_bf16(g0, g1);
    }
    if (store) *reinterpret_cast<uint4*>(dst + 16 * b) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The _epilogue on one output row held by a warp, as the layer-0 kernels
// hold it (conv_encoder.cu, conv_layers.cu): lane l has the f32 sums of
// channels 128 g + 4 l + e in y[4 g + e] (g, e < 4).  The rounded, biased
// values replace the sums in ``y``; the row's statistics are the lane's sum
// in (g, e) order, then warp_sum's xor butterfly; the row goes to ``dst``
// (C bf16) as four 8-byte stores a lane if ``store``.  ``vs`` holds
// stage_vectors' [cb | ln_w | ln_b].
__device__ __forceinline__ void lane_bias_ln_gelu_store(float (&y)[16], const float* vs,
                                                        bf16* __restrict__ dst, int lane,
                                                        bool store) {
  const float4* cb4 = reinterpret_cast<const float4*>(vs) + lane;
  const float4* lw4 = cb4 + C / 4;
  const float4* lb4 = lw4 + C / 4;
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 c = cb4[32 * g];
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = round_bf16(round_bf16(y[4 * g + e]) + round_bf16(cv[e]));
      y[4 * g + e] = v;
      s += v;
      ss += v * v;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / C;
  const float var = fmaxf(ss / C - mean * mean, 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
  if (store) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 lw = lw4[32 * g], lb = lb4[32 * g];
      const float* v = y + 4 * g;
      const uint2 o = make_uint2(
          pack_bf16(gelu_erf(round_bf16((v[0] - mean) * rstd * lw.x + lb.x)),
                    gelu_erf(round_bf16((v[1] - mean) * rstd * lw.y + lb.y))),
          pack_bf16(gelu_erf(round_bf16((v[2] - mean) * rstd * lw.z + lb.z)),
                    gelu_erf(round_bf16((v[3] - mean) * rstd * lw.w + lb.w))));
      *reinterpret_cast<uint2*>(dst + 4 * lane + 128 * g) = o;
    }
  }
}

}  // namespace conv
}  // namespace mmer
