// jax.random's threefry2x32 draws, every draw of a training step in one
// launch (mmer_tpu_torch/ops/prng.py: DrawPlan, launch_threefry).
//
// Not the port of a TPU kernel: the JAX package draws through jax.random,
// which XLA compiles on the TPU.  The port needs JAX's bits on the card (a
// port run from seed s is the JAX run from seed s), and drawing them as
// int64 tensor ops costs about 400 launches a draw.
//
// What it computes, per element e of the launch: the segment s that holds
// it (a (draw, lane) pair of the table), the segment's key (the lane's key,
// then fold_in(key, step) when fold_step is set, then fold_in of each of the
// segment's chain words; fold_in(k, w) is threefry(k, (0, w))), and the
// element's bits threefry(key, (i >> 32, i & 0xffffffff)) xor-ed, at its
// flat index i in the segment (or at index[i] when the segment has an index
// array).  The bits are written as the segment's kind says: the 32 bits
// (int32), a sort key (bits - 2^31 as int32, which orders as the unsigned
// bits do), a uniform (bits >> 9 | 0x3F800000 as a float in [1, 2), minus 1:
// exact), or a keep mask (uniform < keep) as 0 / 1 in float32 or bfloat16.
//
// Bound: integer operations.  A word costs one threefry (20 rounds of an
// add, a rotate and an xor, five key injections) and a few more
// operations, about 90 32-bit integer operations, against a 2- or 4-byte
// store; at the H100's 64 integer lanes an SM and clock the operations take
// several times longer than the bytes.  Design: each block first derives
// every segment's key once in shared memory (one thread a segment, at most
// 128 segments of at most 8 chain words), then each thread takes elements
// grid-stride, finds its segment by binary search over the segments'
// starts, runs the 20 rounds in registers and stores one word.  Neighbouring
// threads store to neighbouring addresses.
#include "common.cuh"

namespace {

constexpr int kFields = 16;     // int64 words a segment of the table takes
constexpr int kMaxChain = 8;
constexpr int kMaxSegments = 128;
constexpr int kMaxLanes = 16;
constexpr int kThreads = 256;

// Table fields (ops/prng.py: DrawPlan).
enum Field { kLane = 0, kCount, kStart, kOffset, kKind, kKeep, kIndex, kChainLen, kChain };
enum Kind { kBits = 0, kSortKey, kUniform, kMaskF32, kMaskBf16 };

struct Keys {
  uint32_t w[2 * kMaxLanes];
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Random123's threefry2x32, 20 rounds, as jax computes it.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}

__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, uint32_t data) {
  uint32_t x0 = 0, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const long long* __restrict__ table, int n_seg, Keys keys,
                    int fold_step, uint32_t step, long long total,
                    uint8_t* __restrict__ out) {
  __shared__ long long start[kMaxSegments];
  __shared__ uint32_t key0[kMaxSegments], key1[kMaxSegments];
  for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
    const long long* row = table + s * kFields;
    const int lane = int(row[kLane]);
    uint32_t k0 = keys.w[2 * lane], k1 = keys.w[2 * lane + 1];
    if (fold_step) fold_in(k0, k1, step);
    const int len = int(row[kChainLen]);
    for (int c = 0; c < len; ++c) fold_in(k0, k1, uint32_t(row[kChain + c]));
    start[s] = row[kStart];
    key0[s] = k0;
    key1[s] = k1;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    int lo = 0, hi = n_seg - 1;          // the last segment starting at or before e
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const long long* row = table + lo * kFields;
    const long long i = e - start[lo];
    const long long* index = reinterpret_cast<const long long*>(row[kIndex]);
    const unsigned long long flat = index ? (unsigned long long)index[i]
                                          : (unsigned long long)i;
    uint32_t x0 = uint32_t(flat >> 32), x1 = uint32_t(flat);
    threefry(key0[lo], key1[lo], x0, x1);
    const uint32_t bits = x0 ^ x1;
    uint8_t* base = out + row[kOffset];
    const int kind = int(row[kKind]);
    if (kind == kBits) {
      reinterpret_cast<uint32_t*>(base)[i] = bits;
    } else if (kind == kSortKey) {
      reinterpret_cast<uint32_t*>(base)[i] = bits ^ 0x80000000u;
    } else {
      const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      if (kind == kUniform) {
        reinterpret_cast<float*>(base)[i] = u;
      } else {
        const float keep = __uint_as_float(uint32_t(row[kKeep]));
        const float m = u < keep ? 1.0f : 0.0f;
        if (kind == kMaskF32)
          reinterpret_cast<float*>(base)[i] = m;
        else
          reinterpret_cast<mmer::bf16*>(base)[i] = __float2bfloat16_rn(m);
      }
    }
  }
}

}  // namespace

MMER_EXPORT int mmer_threefry(const void* table, int n_seg, const void* host_keys,
                              int n_keys, int fold_step, unsigned int step,
                              long long total, void* out, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || n_keys < 1 || n_keys > kMaxLanes ||
      total < 1)
    return int(cudaErrorInvalidValue);
  Keys keys = {};
  const uint32_t* words = static_cast<const uint32_t*>(host_keys);
  for (int i = 0; i < 2 * n_keys; ++i) keys.w[i] = words[i];
  const long long blocks_needed = (total + kThreads - 1) / kThreads;
  const int blocks = int(blocks_needed < 132 * 16 ? blocks_needed : 132 * 16);
  threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_seg, keys, fold_step, step, total,
      static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}
