// int8 products of the int8 ViViT and Wav2Vec2 forwards
// (mmer_tpu_torch/ops/quant.py: row_quant, qdot_int8, qdot, qdot_u8).
//
// Not the port of a TPU kernel: the JAX package (mmer_tpu/ops/quant.py)
// leaves its int8 dot_general, and the dynamic quantize and dequantize around
// it, to XLA.  Two entry points:
//
// - row_quant: one warp a row of float32 or bf16 x, the row read from device
//   memory once and held in registers (K <= 4096: at most 128 values a
//   lane; a wider row is read twice).  The absmax in x's dtype (a max,
//   exact), floored at the floor the wrapper gives (1e-8 rounded to that
//   dtype), xs = absmax / 127 and q = rint(x / xs) (half to even), both true
//   divisions as JAX computes them.  Bound: bytes (read x, write q and xs).
// - int8_gemm: int8 (M, K) x int8 (K, N) -> int32 on the tensor cores
//   (wgmma m64n256k32 s32.s8.s8), K-major operands (the weight is stored
//   (N, K) once, at quantize time), the dequantize in the epilogue:
//   acc * xs[row] * ws[col], or for uint8 pixels (u8 = 1: each byte becomes
//   x ^ 0x80, which is x - 128 as int8, in shared memory before the tensor
//   cores read it) (acc + corr[col]) * ws[col] / denom; then + bias[col]
//   when a bias is given.  Every step rounds as the JAX expression does (the
//   __*_rn intrinsics: nvcc would contract a multiply and an add into one
//   FMA).  Bound: at the model's shapes, the float32 output's bytes (K <=
//   4096 gives at most 2K operations a 4-byte output against 591 operations
//   a byte at the int8 peak).
//
// The GEMM's design.  A persistent grid, one block an SM, walks 128 x 256
// output tiles (N fastest, so that the blocks in flight share A's rows).
// Two warpgroups each own 64 rows x 256 columns as 128 int32 accumulators a
// thread.  K walks in steps of 128 bytes: each step's A tile (128 rows) and B
// tile (256 rows) arrive by 16-byte cp.async in the 128-byte swizzle
// (wgmma.cuh: a 128-byte row holds 128 int8 K values, one k32 step is 32
// bytes along it, as one bf16 k16 step is) in a ring of three stages, and
// each warpgroup issues four m64n256k32 products from shared memory.  The
// ring runs across tiles: the next tile's first two steps are in flight
// while a tile's epilogue runs.  Rows past M, columns past N and bytes past
// K load as zeros and are not stored.  The epilogue dequantizes from the
// accumulators and leaves through shared memory, each warp its 16 rows at a
// 544-byte pitch (no bank conflicts either way), as 512-byte rows of 16-byte
// stores: the left 128 columns at once, the right 128 a few rows a step
// during the next tile's products, so that half of a tile's store burst
// (the output's bytes bound the kernel) overlaps the tensor cores.
// Measured on an H100 against this design (scripts/compare_builds.py; see
// PERF.md): four stages with every store at once (3-8 % slower at K <=
// 1024, 1-3 % faster at K >= 3072); 128 x 128 tiles, two blocks an SM; and
// TMA loads, from a producer warpgroup or inline, with B multicast over a
// two-block cluster, 1.2-1.8x slower: the shared B ties each block to the
// slower of the pair.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using mmer::cp_async_16;
using mmer::sw128;

// ---- row_quant -------------------------------------------------------------

// One row's scale and int8 values from eight floats a chunk, chunk i of the
// lane at column 8 (lane + 32 i).
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int q = __float2int_rn(__fdiv_rn(v[e], s));   // rint: half to even
    w[e >> 2] |= uint32_t(uint8_t(int8_t(q))) << (8 * (e & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K <= 256 NCH: the row in registers, read once.
template <typename T, int NCH>
__global__ void __launch_bounds__(128)
    row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, long long rows, int k, float floor) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * k;
  float v[NCH][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < k) {
      mmer::load8(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
    }
  }
  const float s = __fdiv_rn(fmaxf(warp_max(amax), floor), 127.0f);
  if (lane == 0) xs[row] = s;
  int8_t* qr = xq + row * k;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < k) *reinterpret_cast<uint2*>(qr + c) = quantize8(v[i], s);
  }
}

// K > 4096: the row read twice (the second time from L1 / L2).
template <typename T>
__global__ void __launch_bounds__(128)
    row_quant_kernel_wide(const T* __restrict__ x, int8_t* __restrict__ xq,
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
  const float s = __fdiv_rn(fmaxf(warp_max(amax), floor), 127.0f);
  if (lane == 0) xs[row] = s;
  int8_t* qr = xq + row * k;
  for (int c = lane * 8; c < k; c += 256) {
    float v[8];
    mmer::load8(xr + c, v);
    *reinterpret_cast<uint2*>(qr + c) = quantize8(v, s);
  }
}

// ---- int8_gemm -------------------------------------------------------------

constexpr int kBM = 128, kBN = 256;             // output tile
constexpr int kBK = 128;                        // K bytes a step: one swizzled row
constexpr int kStages = 3;
constexpr int kThreads = 256;                   // two warpgroups
constexpr int kATile = kBM * mmer::SW_ROW_BYTES;          // 16 KB
constexpr int kBTile = kBN * mmer::SW_ROW_BYTES;          // 32 KB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kHalf = kBN / 2;                  // columns of an output half
constexpr int kPitch = kHalf + 8;               // floats a staged row (544 bytes)
constexpr int kWarpStage = 16 * kPitch;         // floats a warp stages: its 16 rows
constexpr int kRowVecs = kHalf / 4;             // 16-byte stores a staged row
constexpr size_t kSmem = 1024 + size_t(kStages) * kStageBytes +
                         size_t(kThreads / 32) * kWarpStage * sizeof(float);
static_assert(kSmem <= 232448, "shared memory a block can use");

// d (64 x 256, s32) (+)= A (64 x 32 bytes, shared, K-major) . B (256 x 32
// bytes, shared, K-major)^T, both int8: one k32 step of the tensor cores'
// integer product.  8-bit operands have no transpose bit: both are K-major.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Pins the order of accumulator accesses against the asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The float of one output: acc . xs . ws (+ bias), or for uint8 rows
// (acc + corr) . ws / denom (+ bias), rounded step by step as JAX does.
template <bool U8>
__device__ __forceinline__ float dequant(int acc, float s, float w, int c, float b,
                                         bool has_bias, float denom) {
  float v = U8 ? __fdiv_rn(__fmul_rn(__int2float_rn(acc + c), w), denom)
               : __fmul_rn(__fmul_rn(__int2float_rn(acc), s), w);
  return has_bias ? __fadd_rn(v, b) : v;
}

template <bool U8>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                     const float* __restrict__ xs, const float* __restrict__ ws,
                     const int* __restrict__ corr, const float* __restrict__ bias,
                     float* __restrict__ out, long long m, int n, int k, float denom) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_ptr = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = mmer::smem_u32(ring_ptr);
  float* staging = reinterpret_cast<float*>(ring_ptr + kStages * kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles = int((m + kBM - 1) / kBM) * n_tiles;
  const int ksteps = (k + kBK - 1) / kBK;
  const int block = blockIdx.x, grid = gridDim.x;
  const int my_tiles = block < tiles ? (tiles - 1 - block) / grid + 1 : 0;
  const int steps = my_tiles * ksteps;

  // The copies of step s (tile s / ksteps of this block, K step s % ksteps):
  // four 16-byte chunks of A and eight of B a thread, chunk tid % 8 of rows
  // tid / 8 + 32 j.
  auto start_copy = [&](int s) {
    if (s < steps) {
      const int tile = block + (s / ksteps) * grid;
      const long long m0 = (long long)(tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * kBN;
      const int kc = (s % ksteps) * kBK + (tid & 7) * 16;
      const bool kin = kc < k;
      const uint32_t stage = ring + (s % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kBM / 32; ++j) {
        const int r = (tid >> 3) + 32 * j;
        const bool valid = kin && m0 + r < m;
        cp_async_16(stage + sw128(r, tid & 7), valid ? a + (m0 + r) * k + kc : a, valid);
      }
#pragma unroll
      for (int j = 0; j < kBN / 32; ++j) {
        const int r = (tid >> 3) + 32 * j;
        const bool valid = kin && n0 + r < n;
        cp_async_16(stage + kATile + sw128(r, tid & 7),
                    valid ? bt + (long long)(n0 + r) * k + kc : bt, valid);
      }
    }
    mmer::cp_async_commit();
  };

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  // The deferred half of the last tile: this warp's 16 rows from d_r0, the
  // 128 columns from d_n0, rows [stored, 16) still to store.
  float* sb = staging + warp * kWarpStage;
  const int per_step = (16 + ksteps - 1) / ksteps;
  bool pending = false;
  int stored = 16, d_n0 = 0;
  long long d_r0 = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) start_copy(s);

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int kt = s % ksteps;
    mmer::cp_async_wait<kStages - 2>();           // this step's tiles have landed ...
    const uint32_t a_tile = ring + (s % kStages) * kStageBytes;
    if (U8) {                                     // ... uint8 rows become x - 128
      unsigned char* tile = ring_ptr + (s % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kBM / 32; ++j) {
        uint4* p = reinterpret_cast<uint4*>(tile + sw128((tid >> 3) + 32 * j, tid & 7));
        uint4 v = *p;
        v.x ^= 0x80808080u; v.y ^= 0x80808080u; v.z ^= 0x80808080u; v.w ^= 0x80808080u;
        *p = v;
      }
    }
    mmer::fence_proxy_async();
    __syncthreads();                              // ... for every thread, visible to wgmma
    fence_acc(acc);
    mmer::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_m64n256k32_s8(acc, mmer::wgmma_desc(a_tile + wg * 64 * mmer::SW_ROW_BYTES + kk * 32),
                          mmer::wgmma_desc(a_tile + kATile + kk * 32), kt > 0 || kk > 0);
    mmer::wgmma_commit();
    // While the tensor cores run, a share of the previous tile's deferred
    // half leaves: this warp's rows, a 512-byte row a store.
    if (pending) {
      const int last = min(stored + per_step, 16);
      for (int r = stored; r < last; ++r) {
        const long long row = d_r0 + r;
        const int col = d_n0 + 4 * lane;
        if (row < m && col < n)
          *reinterpret_cast<float4*>(out + row * n + col) =
              *reinterpret_cast<const float4*>(sb + r * kPitch + 4 * lane);
      }
      stored = last;
      pending = stored < 16;
    }
    mmer::wgmma_wait<1>();                        // the previous step's products are done ...
    __syncthreads();                              // ... in both warpgroups: its stage is free
    start_copy(s + kStages - 1);
    if (kt != ksteps - 1) continue;

    // The tile's epilogue, while the next tile's first steps load.
    mmer::wgmma_wait<0>();
    fence_acc(acc);
    const int tile = block + (s / ksteps) * grid;
    const long long m0 = (long long)(tile / n_tiles) * kBM;
    const int n0 = (tile % n_tiles) * kBN;
    const int g = lane >> 2, t = lane & 3;
    const bool has_bias = bias != nullptr;
    const long long r0 = m0 + wg * 64 + (warp & 3) * 16;   // this warp's 16 rows
    float sc[2] = {0.f, 0.f};
    if (!U8) {
      sc[0] = r0 + g < m ? xs[r0 + g] : 0.f;
      sc[1] = r0 + g + 8 < m ? xs[r0 + g + 8] : 0.f;
    }
    // Left columns first: staged (this warp's rows) and stored now, 512-byte
    // rows of 16-byte stores; then the right columns, staged and left for the
    // next tile's steps to store.  The staging area is free: the previous
    // tile's deferred half left during this tile's steps.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < kHalf / 8; ++jj) {
        const int j = half * (kHalf / 8) + jj;
        const int col = n0 + 8 * j + 2 * t;       // n is a multiple of 8
        const bool cin = col < n;
        const float w0 = cin ? ws[col] : 0.f, w1 = cin ? ws[col + 1] : 0.f;
        const float b0 = cin && has_bias ? bias[col] : 0.f;
        const float b1 = cin && has_bias ? bias[col + 1] : 0.f;
        const int c0 = U8 && cin ? corr[col] : 0, c1 = U8 && cin ? corr[col + 1] : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = dequant<U8>(acc[4 * j + 2 * h], sc[h], w0, c0, b0, has_bias, denom);
          const float v1 = dequant<U8>(acc[4 * j + 2 * h + 1], sc[h], w1, c1, b1, has_bias,
                                       denom);
          *reinterpret_cast<float2*>(sb + (g + 8 * h) * kPitch + 8 * jj + 2 * t) =
              make_float2(v0, v1);
        }
      }
      __syncwarp();
      if (half == 0) {
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
          const long long row = r0 + r;
          const int col = n0 + 4 * lane;
          if (row < m && col < n)
            *reinterpret_cast<float4*>(out + row * n + col) =
                *reinterpret_cast<const float4*>(sb + r * kPitch + 4 * lane);
        }
      }
    }
    d_r0 = r0;
    d_n0 = n0 + kHalf;
    stored = 0;
    pending = true;
  }
  // The last tile's deferred half.
  for (int r = stored; r < 16; ++r) {
    const long long row = d_r0 + r;
    const int col = d_n0 + 4 * lane;
    if (row < m && col < n)
      *reinterpret_cast<float4*>(out + row * n + col) =
          *reinterpret_cast<const float4*>(sb + r * kPitch + 4 * lane);
  }
  mmer::cp_async_wait<0>();
}

}  // namespace

MMER_EXPORT int mmer_row_quant(const void* x, int is_bf16, void* xq, void* xs, long long rows,
                               int k, float floor, void* stream) {
  if (rows < 1 || k < 8 || k % 8) return int(cudaErrorInvalidValue);
  const int rows_per_block = 4;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (k + 255) / 256;          // chunks of 8 values a lane
  auto launch = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    const T* xp = static_cast<const T*>(x);
    int8_t* q = static_cast<int8_t*>(xq);
    float* s = static_cast<float*>(xs);
    const unsigned grid = unsigned(blocks);
    const int threads = 32 * rows_per_block;
    if (nch <= 1) row_quant_kernel<T, 1><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 2) row_quant_kernel<T, 2><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 3) row_quant_kernel<T, 3><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 4) row_quant_kernel<T, 4><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 6) row_quant_kernel<T, 6><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 8) row_quant_kernel<T, 8><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 12) row_quant_kernel<T, 12><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else if (nch <= 16) row_quant_kernel<T, 16><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    else row_quant_kernel_wide<T><<<grid, threads, 0, st>>>(xp, q, s, rows, k, floor);
    return int(cudaGetLastError());
  };
  return is_bf16 ? launch(static_cast<mmer::bf16*>(nullptr))
                 : launch(static_cast<float*>(nullptr));
}

MMER_EXPORT int mmer_int8_gemm(const void* a, int u8, const void* bt, const void* xs,
                               const void* ws, const void* corr, const void* bias, void* out,
                               long long m, int n, int k, float denom, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < 64 || k % 64 || (u8 ? !corr : !xs))
    return int(cudaErrorInvalidValue);
  const long long tiles = (m + kBM - 1) / kBM * ((n + kBN - 1) / kBN);
  const long long steps = tiles * ((k + kBK - 1) / kBK);
  if (steps > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const int sms = mmer::sm_count();
  if (sms < 1) return int(cudaErrorInvalidDevice);
  const unsigned grid = unsigned(tiles < sms ? tiles : sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kSmem));
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
