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
// ~295 FLOP/byte ridge.  At the Wav2Vec2 width (596 tokens, D 1024, N 3072)
// it is 3.7 GFLOP over 6.3 MB of weight: only a grid that spreads N over the
// card reaches the tensor cores (a block for each 64-row tile walking all of
// N would be 10 blocks on 132 SMs).  The design:
//   - a block owns 64 token rows (the wgmma M) and walks a contiguous range of
//     the 256-column tiles of N.  The grid is (row tiles, N slices): one slice
//     when the row tiles alone put a block on every SM, else enough slices to
//     fill the card (ops/fused_blocks.py:ln_matmul_plan, a function of the
//     shape and the SM count only; each output is computed by one block in a
//     fixed order, so the bits do not depend on the plan);
//   - the block's LayerNorm is computed once (common.cuh:ln_tile_bf16_sw128,
//     the FFN's prologue) into a bf16 tile of (64 x D) in shared memory, in
//     the 128-byte swizzle: the A operand of every product;
//   - W (N, D), the nn.Linear layout, is K-major as it stands: tiles of 256
//     rows x 64 k (32 KB) go by 16-byte cp.async through a three-stage ring,
//     across tile boundaries, so the next tile's first copies are in flight
//     during a tile's epilogue; rows at or past N are zero-filled;
//   - two warpgroups each own 128 of a tile's columns: four wgmma m64n128k16
//     a K step into a 64 x 128 f32 accumulator in registers (64 a thread);
//   - the epilogue rounds each pair to bf16 and trades pairs within a quad
//     (three shuffles for each two groups of 8 columns) so that a lane holds
//     8 consecutive columns of one row: one 16-byte store, no scratch tile.
// Staged bytes: a tile moves 256 x D x 2 bytes of W from L2 for 64 x 256 x D
// x 2 FLOP, 64 FLOP a staged byte (the LN tile, once a block, adds D x 128
// bytes); the conv body at 57 read as L2-bound near 7 TB/s on the H100.  The
// next step is 128-row tiles over a cluster pair with a multicast W tile (128
// FLOP a byte).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using mmer::bf16;

constexpr int BM = 64;                                   // token rows a block
constexpr int BN = 256;                                  // output columns a tile
constexpr int KC = 64;                                   // K a step
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;                      // two warpgroups
constexpr int NSTAGE = 3;
constexpr int STAGE_BYTES = BN * mmer::SW_ROW_BYTES;     // 32 KB
constexpr int KTILE_BYTES = BM * mmer::SW_ROW_BYTES;     // 64 rows x 64 k of the LN tile

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + size_t(D / KC) * KTILE_BYTES + size_t(NSTAGE) * STAGE_BYTES;
}
static_assert(smem_bytes<1024>() <= 232448, "shared memory a block can use");

// K step ``k0`` of the W tile whose rows are n0 .. n0 + 255 (64 k of each);
// rows at or past n are zero-filled.  Copy j of a thread is 32 rows below
// copy j - 1, in the same swizzle phase.
template <int D>
__device__ __forceinline__ void load_w_tile(uint32_t dst, const bf16* w, int n0, int n, int k0,
                                            int tid) {
  const int row = tid >> 3, c = tid & 7;
#pragma unroll
  for (int j = 0; j < BN * 8 / NTHREAD; ++j) {
    const int r = row + j * (NTHREAD / 8);
    const bool valid = n0 + r < n;
    mmer::cp_async_16(dst + mmer::sw128(r, c),
                      valid ? w + size_t(n0 + r) * D + k0 + c * 8 : w, valid);
  }
}

// grid (row tiles, n_split): block (x, y) computes rows [64 x, 64 x + 64)
// for N tiles [y T / n_split, (y + 1) T / n_split) of T = ceil(n / 256).
template <int D, typename XT>
__global__ void __launch_bounds__(NTHREAD, 1)
ln_matmul_kernel(const XT* __restrict__ x, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w,
                 bf16* __restrict__ out, int n_tok, int n, int n_split) {
  constexpr int KSTEP = D / KC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = mmer::smem_u32(smem_raw);
  const uint32_t ln_tile = (raw + 1023u) & ~1023u;
  const uint32_t ring = ln_tile + KSTEP * KTILE_BYTES;
  unsigned char* ln_ptr = smem_raw + (ln_tile - raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, quad = lane & 3;
  const long row0 = long(blockIdx.x) * BM;
  const int ntile = (n + BN - 1) / BN;
  const int tile_begin = int(long(blockIdx.y) * ntile / n_split);
  const int tile_end = int(long(blockIdx.y + 1) * ntile / n_split);
  const int nstep = (tile_end - tile_begin) * KSTEP;

  auto start_copy = [&](int step) {
    if (step < nstep)
      load_w_tile<D>(ring + (step % NSTAGE) * STAGE_BYTES, w,
                     (tile_begin + step / KSTEP) * BN, n, (step % KSTEP) * KC, tid);
    mmer::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) start_copy(s);

  // LayerNorm of the block's rows, rounded to bf16 (rows past n_tok are 0);
  // the first step's fence and barrier hand it to wgmma.
  mmer::ln_tile_bf16_sw128<D>(x, ln_w, ln_b, ln_ptr, row0, n_tok, BM, warp, NWARP, lane);

  // This lane's rows after the epilogue's trade: r0 (even quad lanes) or r0 + 8.
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const long tok = row0 + r0 + 8 * (quad & 1);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int step = 0;
#pragma unroll 1
  for (int t = tile_begin; t < tile_end; ++t) {
#pragma unroll 1
    for (int ks = 0; ks < KSTEP; ++ks, ++step) {
      mmer::cp_async_wait<NSTAGE - 2>();    // this step's tile has landed ...
      mmer::fence_proxy_async();
      __syncthreads();                      // ... for every thread, visible to wgmma
      const uint32_t b_tile =
          ring + (step % NSTAGE) * STAGE_BYTES + wg * (BN / 2) * mmer::SW_ROW_BYTES;
      mmer::wgmma_fence_operand(acc);
      mmer::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        mmer::wgmma_m64n128k16_ss(acc, mmer::wgmma_desc(ln_tile + ks * KTILE_BYTES + kk * 32),
                                  mmer::wgmma_desc(b_tile + kk * 32), (ks | kk) != 0);
      mmer::wgmma_commit();
      mmer::wgmma_wait<1>();                // the previous step's products are complete ...
      __syncthreads();                      // ... in both warpgroups: its stage is free
      start_copy(step + NSTAGE - 1);
    }
    mmer::wgmma_wait<0>();
    mmer::wgmma_fence_operand(acc);

    // Epilogue.  acc[4j + 2h], acc[4j + 2h + 1]: row r0 + 8h, columns 8j +
    // 2 quad, + 1 of this warpgroup's 128.  Item i of a pair of groups (2b,
    // 2b + 1) is (row r0 + 8 (i & 1), group 2b + (i >> 1)), a bf16 pair a lane;
    // after the trade lane quad holds item quad whole.
    const int col0 = t * BN + wg * (BN / 2) + 8 * (quad >> 1);
#pragma unroll
    for (int b = 0; b < BN / 2 / 16; ++b) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * b + (i >> 1), h = i & 1;
        v[i] = mmer::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      uint32_t r[4];
      r[0] = mmer::pick4(v, quad);
#pragma unroll
      for (int d = 1; d < 4; ++d) r[d] = __shfl_xor_sync(0xffffffffu, mmer::pick4(v, quad ^ d), d);
      const int col = col0 + 16 * b;
      if (tok < n_tok && col < n)
        *reinterpret_cast<uint4*>(out + tok * n + col) =
            make_uint4(mmer::pick4(r, quad), mmer::pick4(r, quad ^ 1), mmer::pick4(r, quad ^ 2),
                       mmer::pick4(r, quad ^ 3));
    }
  }
  mmer::cp_async_wait<0>();
}

template <int D, typename XT>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w, void* out,
           int n_tok, int n, int n_split, cudaStream_t stream) {
  auto kern = ln_matmul_kernel<D, XT>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((n_tok + BM - 1) / BM, n_split);
  kern<<<grid, NTHREAD, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), n_tok, n, n_split);
  return int(cudaGetLastError());
}

}  // namespace

// x: (n_tok, d) in bf16 (x_is_f32 = 0) or f32 (x_is_f32 = 1); ln_w, ln_b: (d,)
// f32; w: (n, d) bf16; out: (n_tok, n) bf16.  d must be 768 or 1024 and n a
// multiple of 64; n_split in [1, ceil(n / 256)] is the number of slices of
// N's 256-column tiles the grid spreads over blocks.
MMER_EXPORT int mmer_fused_ln_matmul(const void* x, const void* ln_w, const void* ln_b,
                                     const void* w, void* out, int n_tok, int d, int n,
                                     int x_is_f32, void* stream, int n_split) {
  if (n <= 0 || n % 64 != 0 || n_tok <= 0 || n_split < 1 || n_split > (n + BN - 1) / BN)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 768)
    return x_is_f32 ? launch<768, float>(x, ln_w, ln_b, w, out, n_tok, n, n_split, s)
                    : launch<768, bf16>(x, ln_w, ln_b, w, out, n_tok, n, n_split, s);
  if (d == 1024)
    return x_is_f32 ? launch<1024, float>(x, ln_w, ln_b, w, out, n_tok, n, n_split, s)
                    : launch<1024, bf16>(x, ln_w, ln_b, w, out, n_tok, n, n_split, s);
  return int(cudaErrorInvalidValue);
}
