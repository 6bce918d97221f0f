// Wav2Vec2's positional-conv sublayer in one launch: the padded frames of the
// float32 stream zeroed, the grouped conv (64 channels a group, k taps, zero
// padding k/2, the trailing frame of an even kernel not computed), the bias,
// exact-erf GELU and the float32 residual add.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (mmer_tpu/models/wav2vec2.py:185, nn.Conv(feature_group_count=16)), and the
// port ran it as cuDNN's grouped F.conv1d with six elementwise and
// transposing passes around it.  At the long-form extraction shape (64 rows
// of 499 frames) cuDNN picked CUDA-core sgemm algorithms there, and the
// sublayer took 36.6 ms a forward (CUDA events) against a 0.542 ms bound.  Numerics are the port's plain
// version (ops/pos_conv.py:pos_conv_reference): the operands rounded to
// bf16, f32 sums rounded to bf16, the bf16 bias added and rounded, GELU in
// f32 rounded to bf16 once (ROADMAP C4), the residual in f32.
//
// What bounds it on the H100: tensor-core operations.  At 64 x 499 frames it
// is 2 * 64 * 499 * 1024 * 64 * 128 = 535.8 GFLOP (0.542 ms at 989 TFLOP/s)
// against 0.083 ms of bytes (x read and out written in f32, 16.8 MB of bf16
// weights), 2,000 operations a byte.
//
// The design.  An implicit GEMM for each (row, group, tile of frames), the
// output transposed: D (64 output channels x frames) = sum over taps j of
// W_j (64 out x 64 in) . X_j^T, where X_j is the tile's frames shifted by j.
// So the weights are the wgmma A operand (M = 64, one tap's tile of 8 KB in
// the 128-byte swizzle, streamed tap by tap through a cp.async ring) and the
// frames are B (N = 128 or 64 a warpgroup, two warpgroups a block).
// The block's window of frames (tile + k - 1 of them, masked and rounded to
// bf16 once) is staged in shared memory in the no-swizzle (interleaved)
// layout: eight planes, one for each 8 channels, each a column of 16-byte
// frame rows.  A core matrix (8 frames x 8 channels) is then 128 contiguous
// bytes wherever it starts, so the operand of tap j is the window's
// descriptor moved by j rows (16 bytes): no copy a tap, where a swizzled
// tile cannot be moved by one row.  A tap is four m64nNk16 products a
// warpgroup; the accumulator stays in registers and the epilogue (bias,
// GELU, the re-read f32 residual) runs there.  A 256-frame tile reads each
// group's 1 MB of weights once for 256 frames (128 FLOP a byte from L2); a
// 128-frame product reads 6 KB of shared memory (2 KB of the weight tile,
// 4 KB of frame rows) in its 64 tensor-core clocks, 96 bytes a clock within
// the SM's 128 (a 64-frame product 128, at the limit).  Two blocks an SM, so
// that one block's window and epilogue overlap the other's products: at 64 x
// 499 frames on an H100 SXM that beat one block of 512 frames (two
// warpgroups of 256) by 14 % (0.700 against 0.812 ms).  pos_conv_plan
// (ops/pos_conv.py) picks the tile from the shape so that a one-row request
// still spreads over the SMs.  sm_90a only.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

using mmer::bf16;

constexpr int CG = 64;                                  // channels a group
constexpr int CHUNKS = CG / 8;                          // 16-byte chunks of a frame's group
constexpr int MAX_TAPS = 128;
constexpr int NTHREAD = 256;                            // two warpgroups
constexpr int NSTAGE = 4;
constexpr int W_TILE_BYTES = CG * mmer::SW_ROW_BYTES;   // a tap: 64 x 64 bf16, 8 KB

// Rows of the window's planes: the tile's frames and the k - 1 around them,
// rounded up to an odd count so that the eight planes start in eight
// different bank groups (a thread's 16-byte store per plane is then free of
// conflicts with its neighbours').
__host__ __device__ constexpr int window_rows(int frames, int taps) {
  return (frames + taps - 1) | 1;
}

size_t smem_bytes(int frames, int taps) {
  const size_t rows = window_rows(frames, taps);
  return 1024 + size_t(NSTAGE) * W_TILE_BYTES + CHUNKS * rows * 16 + rows;
}

// Descriptor of a K-major operand in the no-swizzle layout: core matrices of
// 8 rows x 16 bytes, each 128 contiguous bytes; ``lbo`` bytes between the
// two core matrices of a 16-deep k-step (two planes), ``sbo`` bytes between
// groups of 8 rows along M or N.
__device__ __forceinline__ uint64_t desc_interleaved(uint32_t addr, uint32_t lbo,
                                                     uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t((lbo >> 4) & 0x3FFFu) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFFu) << 32);
}

template <int N>
struct Mma;
template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    mmer::wgmma_m64n128k16_ss(d, a, b, 1);
  }
};
template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    mmer::wgmma_m64n64k16_ss(d, a, b, 1);
  }
};

// Block (tile, group g, row b): output frames t0 .. t0 + 2N - 1 of channels
// 64 g .. 64 g + 63; warpgroup w owns frames t0 + w N .. + N - 1.  x and out
// (batch, t_len, d) f32; mask (batch, t_len) bytes, non-zero on a padded
// frame, or null; w (d / 64, taps, 64 out, 64 in) bf16; bias (d,) bf16.
template <int N>
__global__ void __launch_bounds__(NTHREAD, 2)
pos_conv_gelu_kernel(const float* __restrict__ x, const unsigned char* __restrict__ mask,
                     const bf16* __restrict__ w, const bf16* __restrict__ bias,
                     float* __restrict__ out, int t_len, int d, int taps) {
  constexpr int F = 2 * N;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = mmer::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int rows = window_rows(F, taps);
  const uint32_t plane = uint32_t(rows) * 16;
  const uint32_t win = ring + NSTAGE * W_TILE_BYTES;
  unsigned char* win_p = smem_raw + (win - raw);
  unsigned char* keep_p = win_p + CHUNKS * plane;    // a byte a window row: frame kept

  const int tid = threadIdx.x, wg = tid >> 7;
  const int t0 = blockIdx.x * F, g = blockIdx.y, b = blockIdx.z;
  const int pad = taps / 2;
  const bf16* wgroup = w + size_t(g) * taps * CG * CG;

  // Tap ``step``'s weight tile into its stage: 64 rows (output channels) of
  // 128 bytes (input channels), two 16-byte copies a thread.
  auto start_copy = [&](int step) {
    if (step < taps) {
      const uint32_t stage = ring + (step % NSTAGE) * W_TILE_BYTES;
      const bf16* src = wgroup + size_t(step) * CG * CG;
#pragma unroll
      for (int j = 0; j < CG * CHUNKS / NTHREAD; ++j) {
        const int i = tid + j * NTHREAD, row = i >> 3, c = i & 7;
        mmer::cp_async_16(stage + mmer::sw128(row, c), src + row * CG + c * 8, true);
      }
    }
    mmer::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) start_copy(s);

  // The window: row r is frame t0 - pad + r, zero where it is padded or lies
  // outside the clip; chunk c (channels 8c .. 8c + 7 of the group) in plane c.
  const float* xb = x + size_t(b) * t_len * d + g * CG;
  const unsigned char* mb = mask ? mask + size_t(b) * t_len : nullptr;
  // UNROLL chunks a thread in flight at once: their loads first, then the
  // stores.
  constexpr int UNROLL = 4;
  const int items = (F + taps - 1) * CHUNKS;
  for (int i0 = tid; i0 < items; i0 += UNROLL * NTHREAD) {
    float v[UNROLL][8];
    bool keep[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * NTHREAD, r = i >> 3, c = i & 7;
      const int t = t0 - pad + r;
      keep[u] = i < items && t >= 0 && t < t_len && !(mb && mb[t]);
      if (keep[u]) mmer::load8(xb + size_t(t) * d + c * 8, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * NTHREAD, r = i >> 3, c = i & 7;
      if (i >= items) break;
      const uint4 packed =
          keep[u] ? make_uint4(mmer::pack_bf16(v[u][0], v[u][1]), mmer::pack_bf16(v[u][2], v[u][3]),
                               mmer::pack_bf16(v[u][4], v[u][5]), mmer::pack_bf16(v[u][6], v[u][7]))
                  : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(win_p + c * plane + r * 16) = packed;
      if (c == 0) keep_p[r] = keep[u];
    }
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t frames = win + uint32_t(wg * N) * 16;

#pragma unroll 1
  for (int step = 0; step < taps; ++step) {
    mmer::cp_async_wait<NSTAGE - 2>();     // this tap's weights have landed ...
    mmer::fence_proxy_async();
    __syncthreads();                       // ... for every thread, visible to wgmma
    const uint32_t a_tile = ring + (step % NSTAGE) * W_TILE_BYTES;
    mmer::wgmma_fence_operand(acc);
    mmer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CG / 16; ++kk)
      Mma<N>::run(acc, mmer::wgmma_desc(a_tile + kk * 32),
                  desc_interleaved(frames + 2 * kk * plane + uint32_t(step) * 16, plane, 128));
    mmer::wgmma_commit();
    mmer::wgmma_wait<1>();                 // the previous tap's products are complete ...
    __syncthreads();                       // ... in both warpgroups: its stage is free
    start_copy(step + NSTAGE - 1);
  }
  mmer::wgmma_wait<0>();
  mmer::wgmma_fence_operand(acc);

  // acc[4j + 2h + e]: output channel 16 (warp % 4) + lane / 4 + 8h of the
  // group, frame 8j + 2 (lane % 4) + e of the warpgroup's (wgmma.cuh).
  const int lane = tid & 31, quad = lane & 3;
  const int c0 = g * CG + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const float bias0 = __bfloat162float(bias[c0]), bias1 = __bfloat162float(bias[c0 + 8]);
  const float* xrow = x + size_t(b) * t_len * d;
  float* orow = out + size_t(b) * t_len * d;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = wg * N + 8 * j + 2 * quad + e;
      const int t = t0 + f;
      if (t < t_len) {
        const bool keep = keep_p[f + pad];
        const size_t at = size_t(t) * d + c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = mmer::round_bf16(mmer::round_bf16(acc[4 * j + 2 * h + e]) +
                                           (h ? bias1 : bias0));
          const float gelu = mmer::round_bf16(mmer::gelu_erf(y));
          orow[at + 8 * h] = (keep ? xrow[at + 8 * h] : 0.f) + gelu;
        }
      }
    }
  }
}

template <int N>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* x, const unsigned char* mask,
                   const bf16* w, const bf16* bias, float* out, int t_len, int d, int taps) {
  const size_t smem = smem_bytes(2 * N, taps);
  const cudaError_t err = cudaFuncSetAttribute(
      pos_conv_gelu_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  pos_conv_gelu_kernel<N><<<grid, NTHREAD, smem, stream>>>(x, mask, w, bias, out, t_len, d,
                                                           taps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (batch, t_len, d) f32 contiguous; mask: (batch, t_len) bool or
// null; w: (d / 64, taps, 64, 64) bf16 (group, tap, output channel, input
// channel); bias: (d,) bf16; tile: frames a block, 256 or 128
// (ops/pos_conv.py:pos_conv_plan).
MMER_EXPORT int mmer_pos_conv_gelu(const void* x, const void* mask, const void* w,
                                   const void* bias, void* out, int batch, int t_len, int d,
                                   int taps, int tile, void* stream) {
  if (batch <= 0 || batch > 65535 || t_len <= 0 || d <= 0 || d % CG != 0 || taps < 1 ||
      taps > MAX_TAPS || (long long)batch * t_len * d >= (1LL << 40))
    return int(cudaErrorInvalidValue);
  const dim3 grid((t_len + tile - 1) / tile, d / CG, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* bb = static_cast<const bf16*>(bias);
  float* of = static_cast<float*>(out);
  switch (tile) {
    case 256: return int(launch<128>(grid, s, xf, m, wb, bb, of, t_len, d, taps));
    case 128: return int(launch<64>(grid, s, xf, m, wb, bb, of, t_len, d, taps));
    default: return int(cudaErrorInvalidValue);
  }
}
