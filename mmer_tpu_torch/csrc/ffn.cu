// Fused pre-norm FFN sublayer:  out = x + GELU_erf(LN(x) W1^T + b1) W2^T + b2
//
// Replaces the Pallas kernel mmer_tpu/ops/fused_blocks.py:_ffn_kernel (public
// fused_ffn).  Same numerics: LayerNorm in float32 (flax: eps 1e-6,
// var = max(0, E[x^2] - E[x]^2)), LN output rounded to bf16 for the first
// GEMM, f32 accumulation, bias + exact-erf GELU in f32, hidden rounded to
// bf16 for the second GEMM, residual and output bias in f32, output in x's
// dtype (bf16 for the ViViT stream, f32 for the Wav2Vec2 stream).
//
// What bounds it on the H100.  At a full grid (12,552 tokens x 768, M 3072:
// 118 GFLOP against 47 MB) the function is far above the card's ~295
// FLOP/byte ridge: tensor-core throughput.  At Wav2Vec2's serving shapes
// (149-1,500 tokens x 1024, M 4096) it is 16.8 MB of weights that 3-24 row
// tiles cannot pull through the card: latency, unless the grid is filled.
// An earlier WMMA body (32 rows a block, weight fragments straight from L2)
// reached 8.7 % of peak at a full grid and took 0.77 ms whatever the token
// count below 1,500.  This body:
//   - a block owns 64 token rows (the wgmma M) and D/2 output columns, two
//     warpgroups, one block an SM; the two blocks that share a row tile are a
//     thread block cluster.  The hidden tensor never leaves the pair: it walks
//     its hidden units in chunks of 256; for each chunk every block computes
//     the first product for 128 of them (LN tile (64, D) from shared memory .
//     W1 rows^T, wgmma m64n64k16 per warpgroup), applies bias + GELU to the
//     accumulator in registers and stores the bf16 result into the 32 KB
//     hidden tile of both blocks (its own and, through distributed shared
//     memory, its peer's); the second product (hidden chunk . W2 slice^T,
//     m64n128k16 / m64n96k16) adds into the (64, D/2) f32 output accumulator
//     that lives in registers for the whole walk (128 / 96 a thread).  So
//     neither product is computed twice, and each block reads half of W1;
//   - weights go through shared memory once per block: W1 (128 hidden x 128 k)
//     and W2 (D/4 outputs x 64 hidden) tiles of at most 32 KB arrive by 16-byte
//     cp.async into a ring of 3 (D = 768) or 2 (D = 1024, whose LN tile takes
//     128 KB) stages in the 128-byte swizzle.  With three stages a step's
//     products stay in flight across the hand-over barrier and the start of
//     the next copies; with two a stage is refilled as soon as its products
//     are complete; both nn.Linear layouts are K-major B operands as they
//     stand;
//   - the grid is (row tiles, 2 halves of D, M slices).  The host picks the
//     number of M slices from the token count (ops/fused_blocks.py:ffn_plan):
//     one at a full grid, enough to put a block on every SM at 149-1,500
//     tokens.  With more than one slice each block writes its partial (64,
//     D/2) tile to an f32 workspace and ffn_reduce_kernel adds the slices in
//     index order, with the residual and b2: no atomics, the same bits on
//     every call;
//   - the epilogue trades one pair of values between neighbouring lanes so
//     that each lane holds four consecutive columns of one row: residual
//     read and store are 16 bytes a lane for the f32 stream, 8 for bf16.
// What the design pays.  The hidden chunk is the A operand of the second
// product from shared memory, not from registers: a (64, D) f32 accumulator is
// 192-256 KB of the SM's 256 KB register file, so the output is spread over
// four warpgroups on two SMs, and a warpgroup can take from registers only
// the hidden units it computed itself; a register operand would make each
// of the four compute the whole chunk (4x the first product).  The exchange
// costs 8 KB of stores a warpgroup and two cluster barrier phases a chunk, the
// first of them hidden behind the next chunk's first product.  With 64 rows a
// block streams one weight byte from L2 per 65 FLOP, which caps a full grid
// near a third of the tensor peak; measured, the body sits below that cap,
// and what it loses it loses at the per-step hand-over: builds without the
// weight copies or without either product are each only 10-20 % faster.  At
// D = 1024 there is room for two ring stages only, so the tensor pipe drains
// at every step.  Open steps: 128-row tiles with multicast loads over a larger
// cluster, and a third stage at D = 1024.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using mmer::bf16;

constexpr int BM = 64;        // token rows per block
constexpr int MC = 256;       // hidden units per chunk of the pair
constexpr int HB = MC / 2;    // of which a block computes
constexpr int D_SPLIT = 2;    // blocks per row tile (one cluster), each owning D / 2 columns
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int TILE_BYTES = 64 * mmer::SW_ROW_BYTES;    // 64 rows x 64 bf16
constexpr int STAGE_BYTES = MC * mmer::SW_ROW_BYTES;   // up to 256 rows x 64 bf16
constexpr int H_BYTES = (MC / 64) * TILE_BYTES;

template <int D>
struct Cfg {
  static constexpr int DB = D / D_SPLIT;     // output columns per block
  static constexpr int NW = DB / 4;          // columns per warpgroup and W2 tile
  static constexpr int NSTAGE = D == 768 ? 3 : 2;
  static constexpr int LN_BYTES = (D / 64) * TILE_BYTES;
  static constexpr int G1 = D / 128;         // W1 tiles (steps) per chunk
  static constexpr int G2 = 2 * (MC / 64);   // W2 tiles (steps) per chunk
  static constexpr size_t SMEM = 1024 + LN_BYTES + H_BYTES + NSTAGE * STAGE_BYTES;
  static_assert(NW == 96 || NW == 128, "second-product widths this file uses");
  static_assert(SMEM <= 232448, "shared memory a block can use");
};

template <int NW>
__device__ __forceinline__ void second_product(float (&acc)[NW / 2], uint64_t a, uint64_t b) {
  if constexpr (NW == 128) mmer::wgmma_m64n128k16_ss(acc, a, b, 1);
  else mmer::wgmma_m64n96k16_ss(acc, a, b, 1);
}

// Start the copies of weight tile ``r`` of a chunk into ring stage ``dst``.
// A chunk of 256 hidden units starting at ``m0`` is, for the block of rank
// ``rank``, G1 tiles of W1, rows [m0 + 128 rank, + 128) x columns [128 r, 128 r
// + 128) as two swizzled (128 x 64) tiles, then G2 tiles of W2, rows (output
// columns) [d0 + half * DB/2, + DB/2) x columns [m0 + 64 hb, + 64).
template <int D>
__device__ __forceinline__ void load_weight_tile(uint32_t dst, const bf16* w1, const bf16* w2,
                                                 int m, int m0, int d0, int rank, int r,
                                                 int tid) {
  using C = Cfg<D>;
  // Copy j of a thread is NTHREAD 16-byte chunks after copy j - 1: a fixed
  // number of rows further down, in the same chunk column and swizzle phase,
  // so source and destination advance by constants.
  if (r < C::G1) {
    const int row = tid >> 4, c = tid & 15;          // 16 chunks a row: 128 k
    const bf16* src = w1 + size_t(m0 + rank * HB + row) * D + r * 128 + c * 8;
    const uint32_t to = dst + (c >> 3) * (HB * mmer::SW_ROW_BYTES) + mmer::sw128(row, c & 7);
#pragma unroll
    for (int j = 0; j < HB * 16 / NTHREAD; ++j)
      mmer::cp_async_16(to + j * (NTHREAD / 16) * mmer::SW_ROW_BYTES,
                        src + size_t(j) * (NTHREAD / 16) * D, true);
  } else {
    const int hb = (r - C::G1) >> 1, half = (r - C::G1) & 1;
    const int row = tid >> 3, c = tid & 7;           // 8 chunks a row: 64 hidden
    const bf16* src = w2 + size_t(d0 + half * (C::DB / 2) + row) * m + m0 + hb * 64 + c * 8;
    const uint32_t to = dst + mmer::sw128(row, c);
#pragma unroll
    for (int j = 0; j < (C::DB / 2) * 8 / NTHREAD; ++j)
      mmer::cp_async_16(to + j * (NTHREAD / 8) * mmer::SW_ROW_BYTES,
                        src + size_t(j) * (NTHREAD / 8) * m, true);
  }
}

// grid (row tiles, D_SPLIT, m_split) in clusters of (1, D_SPLIT, 1).  With
// m_split == 1 the block writes out = x + acc + b2; otherwise its f32 partial
// tile into partial[blockIdx.z][n_tok][D].
template <int D, typename XT>
__global__ void __launch_bounds__(NTHREAD, 1)
ffn_kernel(const XT* __restrict__ x, const float* __restrict__ ln_w,
           const float* __restrict__ ln_b, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, XT* __restrict__ out, float* __restrict__ partial,
           int n_tok, int m, int m_split) {
  using C = Cfg<D>;
  constexpr int NSTAGE = C::NSTAGE, SPC = C::G1 + C::G2, NW = C::NW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = mmer::smem_u32(smem_raw);
  const uint32_t ln_tile = (raw + 1023u) & ~1023u;
  const uint32_t h_tile = ln_tile + C::LN_BYTES;
  const uint32_t ring = h_tile + H_BYTES;
  unsigned char* ln_ptr = smem_raw + (ln_tile - raw);
  unsigned char* h_ptr = ln_ptr + C::LN_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, quad = lane & 3;
  const int trow = (warp & 3) * 16 + (lane >> 2);      // this lane's first tile row
  const long n0 = long(blockIdx.x) * BM;
  const int rank = int(mmer::cluster_rank()), peer = rank ^ 1;
  const int d0 = rank * C::DB;
  const int nchunk = m / MC;
  const int c_begin = int(long(blockIdx.z) * nchunk / m_split);
  const int c_end = int(long(blockIdx.z + 1) * nchunk / m_split);
  const int nstep = (c_end - c_begin) * SPC;

  auto start_copy = [&](int step) {
    if (step < nstep)
      load_weight_tile<D>(ring + (step % NSTAGE) * STAGE_BYTES, w1, w2, m,
                          (c_begin + step / SPC) * MC, d0, rank, step % SPC, tid);
    mmer::cp_async_commit();
  };
  // The ring.  With three stages the products of a step stay in flight
  // while the block hands the previous step's stage back (DEFER): the tensor
  // cores run through the barrier and the start of the next copies, and two
  // tiles are in flight or landed ahead of the one being multiplied.  With two
  // stages a stage is handed back as soon as its own products are complete.
  constexpr bool DEFER = NSTAGE >= 3;
  constexpr int AHEAD = DEFER ? NSTAGE - 1 : NSTAGE;   // tiles copied ahead
  // Top of a step: its tile has landed and is visible to wgmma.
  auto next_stage = [&](int step) -> uint32_t {
    mmer::cp_async_wait<AHEAD - 1>();
    mmer::fence_proxy_async();
    __syncthreads();
    return ring + (step % NSTAGE) * STAGE_BYTES;
  };
  // After a step's products are started: every warp's products on the stage
  // that is handed back are complete, so the next copy may overwrite it.
  auto release_stage = [&](int step) {
    if constexpr (DEFER) mmer::wgmma_wait<1>();
    else mmer::wgmma_wait<0>();
    __syncthreads();
    start_copy(step + AHEAD);
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) start_copy(s);

  // LayerNorm of the block's rows, rounded to bf16 (rows past n_tok are 0).
  mmer::ln_tile_bf16_sw128<D>(x, ln_w, ln_b, ln_ptr, n0, n_tok, BM, warp, NWARP, lane);

  float acc[2][NW / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[h][i] = 0.f;

  mmer::cluster_arrive();          // "no hidden tile is being read yet"
  int step = 0;
  for (int c = c_begin; c < c_end; ++c) {
    // First product, this block's half of the chunk: hidden (64 x 128) =
    // LN(x) (64 x D) . W1[m0 + 128 rank .. + 128]^T; warpgroup wg owns hidden
    // columns [64 wg, 64 wg + 64) of it.
    float hacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    for (int r = 0; r < C::G1; ++r, ++step) {
      const uint32_t b_tile = next_stage(step) + wg * (64 * mmer::SW_ROW_BYTES);
      mmer::wgmma_fence_operand(hacc);
      mmer::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        mmer::wgmma_m64n64k16_ss(
            hacc, mmer::wgmma_desc(ln_tile + (2 * r + (kk >> 2)) * TILE_BYTES + (kk & 3) * 32),
            mmer::wgmma_desc(b_tile + (kk >> 2) * (HB * mmer::SW_ROW_BYTES) + (kk & 3) * 32),
            (r | kk) != 0);
      mmer::wgmma_commit();
      release_stage(step);
    }
    mmer::wgmma_wait<0>();
    mmer::wgmma_fence_operand(hacc);

    // Bias + exact-erf GELU in f32 on the accumulator, rounded to bf16 into
    // the hidden tile (four swizzled (64 x 64) tiles; this warpgroup's is
    // number 2 rank + wg) of this block and of its peer.  The peer is done
    // reading the previous chunk's hidden tile once it has arrived.
    mmer::cluster_wait();
    {
      const int sub = 2 * rank + wg;
      const float* b1c = b1 + size_t(c) * MC + sub * 64;
      const uint32_t h_sub = h_tile + sub * TILE_BYTES;
      const uint32_t h_peer = mmer::cluster_map(h_sub, peer);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i >> 2) + 2 * quad;
        const int row = trow + ((i >> 1) & 1) * 8;
        const float2 bias = *reinterpret_cast<const float2*>(b1c + col);
        const __nv_bfloat162 hv = __floats2bfloat162_rn(mmer::gelu_erf(hacc[i] + bias.x),
                                                        mmer::gelu_erf(hacc[i + 1] + bias.y));
        const uint32_t off = mmer::sw128(row, col >> 3) + (col & 7) * 2;
        const uint32_t bits = *reinterpret_cast<const uint32_t*>(&hv);
        *reinterpret_cast<uint32_t*>(h_ptr + sub * TILE_BYTES + off) = bits;
        mmer::st_cluster_u32(h_peer + off, bits);
      }
    }
    mmer::fence_proxy_async_all();
    mmer::cluster_arrive();
    mmer::cluster_wait();          // both halves of the hidden chunk are in place
    mmer::fence_proxy_async_all();

    // Second product: acc (64 x D/2) += hidden (64 x 256) . W2[block's
    // columns, chunk]^T; a tile holds one half's columns for 64 hidden units,
    // warpgroup wg owns columns [NW wg, NW wg + NW) of it.
#pragma unroll
    for (int hb = 0; hb < MC / 64; ++hb) {
#pragma unroll
      for (int half = 0; half < 2; ++half, ++step) {
        const uint32_t b_tile = next_stage(step) + wg * (NW * mmer::SW_ROW_BYTES);
        const uint32_t a_tile = h_tile + hb * TILE_BYTES;
        mmer::wgmma_fence_operand(acc[half]);
        mmer::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          second_product<NW>(acc[half], mmer::wgmma_desc(a_tile + kk * 32),
                             mmer::wgmma_desc(b_tile + kk * 32));
        mmer::wgmma_commit();
        release_stage(step);
      }
    }
    mmer::wgmma_wait<0>();
    mmer::wgmma_fence_operand(acc[0]);
    mmer::wgmma_fence_operand(acc[1]);
    mmer::cluster_arrive();        // done reading this chunk's hidden tile
  }
  mmer::cp_async_wait<0>();
  mmer::cluster_wait();            // nothing of the pair is in flight at exit

  // Epilogue.  Lanes 2p and 2p + 1 of a quad trade one pair: the even lane
  // ends with four consecutive columns of the first row, the odd lane with
  // the same columns of the row 8 below.
  const bool odd = quad & 1;
  const long n = n0 + trow + (odd ? 8 : 0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float a0 = acc[half][4 * j], a1 = acc[half][4 * j + 1];
      const float a2 = acc[half][4 * j + 2], a3 = acc[half][4 * j + 3];
      const float t0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
      const float t1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
      const float4 val = odd ? make_float4(t0, t1, a2, a3) : make_float4(a0, a1, t0, t1);
      const int col = d0 + half * (C::DB / 2) + wg * NW + 8 * j + 2 * (quad & 2);
      if (n >= n_tok) continue;
      if (m_split > 1) {
        *reinterpret_cast<float4*>(partial + (size_t(blockIdx.z) * n_tok + n) * D + col) = val;
      } else {
        const float4 bias = *reinterpret_cast<const float4*>(b2 + col);
        if constexpr (sizeof(XT) == 4) {
          const float4 xr = *reinterpret_cast<const float4*>(x + n * D + col);
          *reinterpret_cast<float4*>(out + n * D + col) =
              make_float4(xr.x + val.x + bias.x, xr.y + val.y + bias.y,
                          xr.z + val.z + bias.z, xr.w + val.w + bias.w);
        } else {
          const uint2 xr = *reinterpret_cast<const uint2*>(x + n * D + col);
          const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
          const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
          const __nv_bfloat162 o01 =
              __floats2bfloat162_rn(x01.x + val.x + bias.x, x01.y + val.y + bias.y);
          const __nv_bfloat162 o23 =
              __floats2bfloat162_rn(x23.x + val.z + bias.z, x23.y + val.w + bias.w);
          uint2 packed;
          packed.x = *reinterpret_cast<const uint32_t*>(&o01);
          packed.y = *reinterpret_cast<const uint32_t*>(&o23);
          *reinterpret_cast<uint2*>(out + n * D + col) = packed;
        }
      }
    }
  }
}

// out = x + (partial[0] + partial[1] + ... in index order) + b2, four
// columns a thread.
template <typename XT>
__global__ void ffn_reduce_kernel(const XT* __restrict__ x, const float* __restrict__ b2,
                                  const float* __restrict__ partial, XT* __restrict__ out,
                                  long n_elem, int d, int m_split) {
  for (long i = (long(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < n_elem;
       i += long(gridDim.x) * blockDim.x * 4) {
    float4 sum = *reinterpret_cast<const float4*>(partial + i);
    for (int z = 1; z < m_split; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(partial + z * n_elem + i);
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    const float4 bias = *reinterpret_cast<const float4*>(b2 + i % d);
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    const float b[4] = {bias.x, bias.y, bias.z, bias.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[i + e] = mmer::from_f32<XT>(mmer::to_f32(x[i + e]) + v[e] + b[e]);
  }
}

template <int D, typename XT>
int launch(const void* x, const void* ln_w, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, void* partial,
           int n_tok, int m, int m_split, cudaStream_t stream) {
  auto kern = ffn_kernel<D, XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Cfg<D>::SMEM));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_tok + BM - 1) / BM, D_SPLIT, m_split);
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = Cfg<D>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = D_SPLIT;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const XT*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<XT*>(out), static_cast<float*>(partial),
      n_tok, m, m_split);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// x, out: (n_tok, d) in bf16 (x_is_f32 = 0) or f32 (x_is_f32 = 1);
// ln_w, ln_b, b1 (m), b2 (d): f32; w1 (m, d), w2 (d, m): bf16.
// d must be 768 or 1024 and m a multiple of 256.  m_split in [1, m / 256] is
// the number of slices of the hidden dimension the grid spreads over blocks;
// above 1, ``partial`` is an f32 workspace of (m_split, n_tok, d) that the
// blocks fill and mmer_fused_ffn_reduce then reduces into ``out``.
MMER_EXPORT int mmer_fused_ffn(const void* x, const void* ln_w, const void* ln_b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, void* partial, int n_tok, int d,
                               int m, int m_split, int x_is_f32, void* stream) {
  if (m % MC != 0 || n_tok <= 0 || m_split < 1 || m_split > m / MC ||
      (m_split > 1 && partial == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 768)
    return x_is_f32 ? launch<768, float>(x, ln_w, ln_b, w1, b1, w2, b2, out, partial, n_tok, m,
                                         m_split, s)
                    : launch<768, bf16>(x, ln_w, ln_b, w1, b1, w2, b2, out, partial, n_tok, m,
                                        m_split, s);
  if (d == 1024)
    return x_is_f32 ? launch<1024, float>(x, ln_w, ln_b, w1, b1, w2, b2, out, partial, n_tok, m,
                                          m_split, s)
                    : launch<1024, bf16>(x, ln_w, ln_b, w1, b1, w2, b2, out, partial, n_tok, m,
                                         m_split, s);
  return int(cudaErrorInvalidValue);
}

// The second pass of a call with m_split > 1: out = x + sum of the partial
// tiles (in slice order) + b2.
MMER_EXPORT int mmer_fused_ffn_reduce(const void* x, const void* b2, const void* partial,
                                      void* out, int n_tok, int d, int m_split, int x_is_f32,
                                      void* stream) {
  if (n_tok <= 0 || d % 4 != 0 || m_split < 2) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long n_elem = long(n_tok) * d;
  const int threads = 256;
  const int blocks = int((n_elem / 4 + threads - 1) / threads);
  if (x_is_f32)
    ffn_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(b2),
        static_cast<const float*>(partial), static_cast<float*>(out), n_elem, d, m_split);
  else
    ffn_reduce_kernel<bf16><<<blocks, threads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(b2),
        static_cast<const float*>(partial), static_cast<bf16*>(out), n_elem, d, m_split);
  return int(cudaGetLastError());
}
