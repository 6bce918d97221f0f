// int8 products of the int8 ViViT and Wav2Vec2 forwards
// (mmer_tpu_torch/ops/quant.py: row_quant, qdot_int8, qdot, qdot_u8).
//
// Not the port of a TPU kernel: the JAX package (mmer_tpu/ops/quant.py)
// leaves its int8 dot_general, and the dynamic quantize and dequantize around
// it, to XLA.  Two entry points:
//
// - row_quant: one warp a row of float32 or bf16 x.  The absmax in x's
//   dtype (a max, exact), floored at the floor the wrapper gives (1e-8
//   rounded to that dtype), xs = absmax / 127 and q = rint(x / xs) (half to
//   even), both true divisions as JAX computes them.  Bound: bytes (read x,
//   write q and xs); the row is read twice, the second time from L1 / L2.
// - int8_gemm: int8 (M, K) x int8 (K, N) -> int32 on the tensor cores
//   (mma.sync m16n8k32 s8.s8.s32), K-contiguous operands (the weight is
//   stored (N, K) once, at quantize time), the dequantize in the epilogue:
//   acc * xs[row] * ws[col], or for uint8 pixels (u8 = 1: each byte is
//   read as x ^ 0x80, which is x - 128 as int8) (acc + corr[col]) * ws[col]
//   / denom; then + bias[col] when a bias is given.  Every step rounds as
//   the JAX expression does (the __*_rn intrinsics: nvcc would contract a
//   multiply and an add into one FMA).  Bound: at the model's shapes, the
//   float32 output's bytes (K <= 4096 gives at most 2K operations a 4-byte
//   output against 591 operations a byte at the int8 peak).
//
// Design (simple first): 128 x 128 output tiles, 8 warps of 64 x 32, K in
// stages of 64 bytes through a 4-deep cp.async ring in shared memory (rows
// padded to 80 bytes, so that ldmatrix reads no bank twice), fragments by
// ldmatrix.x4.  Rows past M and columns past N load as zeros and are not
// stored.  wgmma with s8 operands, TMA, and row_quant fused into the GEMM's
// prologue are left for later work (ROADMAP queue B).
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;   // tile; kBK in bytes
constexpr int kStages = 4;
constexpr int kPitch = kBK + 16;                // a shared row, in bytes
constexpr int kThreads = 256;
constexpr int kTileBytes = (kBM + kBN) * kPitch;
constexpr int kSmem = kStages * kTileBytes;

// ---- row_quant -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, long long rows, int k, float floor) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * k;
  float amax = 0.f;
  for (int c = lane * 8; c < k; c += 256) {
    float v[8];
    mmer::load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, floor), 127.0f);
  if (lane == 0) xs[row] = s;
  int8_t* qr = xq + row * k;
  for (int c = lane * 8; c < k; c += 256) {
    float v[8];
    mmer::load8(xr + c, v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q = __float2int_rn(__fdiv_rn(v[e], s));   // rint: half to even
      w[e >> 2] |= uint32_t(uint8_t(int8_t(q))) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
  }
}

// ---- int8_gemm -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: rows [m0, m0 + 128) of A and [n0, n0 + 128) of Bt, bytes
// [k0, k0 + 64) of each, 16 bytes a copy, two copies a thread and operand.
__device__ __forceinline__ void load_stage(const int8_t* a, const int8_t* bt,
                                           unsigned char* tile, long long m0, int n0, int k0,
                                           long long m, int n, int k) {
  const uint32_t base = smem_addr(tile);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;     // 0..511
    const int r = c >> 2, col = (c & 3) * 16;
    const long long ra = m0 + r;
    const int8_t* src = a + (ra < m ? ra : 0) * (long long)k + k0 + col;
    cp_async16(base + r * kPitch + col, src, ra < m ? 16 : 0);
    const int rb = n0 + r;
    const int8_t* srcb = bt + (long long)(rb < n ? rb : 0) * k + k0 + col;
    cp_async16(base + (kBM + r) * kPitch + col, srcb, rb < n ? 16 : 0);
  }
}

template <bool U8>
__global__ void __launch_bounds__(kThreads, 2)
    int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                     const float* __restrict__ xs, const float* __restrict__ ws,
                     const int* __restrict__ corr, const float* __restrict__ bias,
                     float* __restrict__ out, long long m, int n, int k, float denom) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;          // 2 x 4 warps of 64 x 32
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kt_count = k / kBK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_stage(a, bt, smem + s * kTileBytes, m0, n0, s * kBK, m, n, k);
    cp_commit();
  }

  // ldmatrix row addresses of this lane: A by m16 tile, Bt by pairs of n8 tiles.
  const int a_row = wm * 64 + (lane & 15), a_col = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_count)
      load_stage(a, bt, smem + (next % kStages) * kTileBytes, m0, n0, next * kBK, m, n, k);
    cp_commit();

    const uint32_t tile = smem_addr(smem + (kt % kStages) * kTileBytes);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(af[i], tile + (a_row + i * 16) * kPitch + ks + a_col);
        if (U8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[i][e] ^= 0x80808080u;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(bf[j], tile + (kBM + b_row + j * 16) * kPitch + ks + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_wait<0>();

  // Epilogue: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * t;
    if (col >= n) continue;                        // n is a multiple of 8
    const float w0 = ws[col], w1 = ws[col + 1];
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
    const int c0 = U8 ? corr[col] : 0, c1 = U8 ? corr[col + 1] : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * 64 + i * 16 + g + 8 * h;
        if (row >= m) continue;
        float v0, v1;
        if (U8) {
          v0 = __fdiv_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h] + c0), w0), denom);
          v1 = __fdiv_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1] + c1), w1), denom);
        } else {
          const float s = xs[row];
          v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), s), w0);
          v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s), w1);
        }
        if (bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        *reinterpret_cast<float2*>(out + row * n + col) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace

MMER_EXPORT int mmer_row_quant(const void* x, int is_bf16, void* xq, void* xs, long long rows,
                               int k, float floor, void* stream) {
  if (rows < 1 || k < 8 || k % 8) return int(cudaErrorInvalidValue);
  const int rows_per_block = 8;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    row_quant_kernel<mmer::bf16><<<unsigned(blocks), 32 * rows_per_block, 0, st>>>(
        static_cast<const mmer::bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs),
        rows, k, floor);
  else
    row_quant_kernel<float><<<unsigned(blocks), 32 * rows_per_block, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), rows,
        k, floor);
  return int(cudaGetLastError());
}

MMER_EXPORT int mmer_int8_gemm(const void* a, int u8, const void* bt, const void* xs,
                               const void* ws, const void* corr, const void* bias, void* out,
                               long long m, int n, int k, float denom, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < kBK || k % kBK || (u8 ? !corr : !xs))
    return int(cudaErrorInvalidValue);
  const long long m_tiles = (m + kBM - 1) / kBM;
  if (m_tiles > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid((n + kBN - 1) / kBN, unsigned(m_tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return int(e);
    kernel<<<grid, kThreads, kSmem, st>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt),
        static_cast<const float*>(xs), static_cast<const float*>(ws),
        static_cast<const int*>(corr), static_cast<const float*>(bias),
        static_cast<float*>(out), m, n, k, denom);
    return int(cudaGetLastError());
  };
  return u8 ? launch(int8_gemm_kernel<true>) : launch(int8_gemm_kernel<false>);
}
