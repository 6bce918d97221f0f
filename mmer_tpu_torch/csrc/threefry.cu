// jax.random's threefry2x32 draws, every draw of a training step in one
// launch (mmer_tpu_torch/ops/prng.py: DrawPlan, launch_threefry).
//
// Not the port of a TPU kernel: the JAX package draws through jax.random,
// which XLA compiles on the TPU.  The port needs JAX's bits on the card (a
// port run from seed s is the JAX run from seed s), and drawing them as
// int64 tensor ops costs about 400 launches a draw.
//
// What it computes, per element of a segment (a (draw, lane) pair of the
// table): the segment's key (the lane's key, then fold_in(key, step) when
// fold_step is set, then fold_in of each of the segment's chain words;
// fold_in(k, w) is threefry(k, (0, w))), and the element's bits
// threefry(key, (i >> 32, i & 0xffffffff)) xor-ed, at its flat index i in
// the segment (or at index[i] when the segment has an index array).  The
// bits are written as the segment's kind says: the 32 bits (int32), a sort
// key (bits - 2^31 as int32, which orders as the unsigned bits do), a
// uniform (bits >> 9 | 0x3F800000 as a float in [1, 2), minus 1: exact), or
// a keep mask (uniform < keep) as 0 / 1 in float32 or bfloat16.
//
// Bound: integer operations.  A word costs one threefry (20 rounds of an
// add, a rotate and an xor, five key injections) and a few more
// operations, about 76 32-bit integer operations, against a 2- or 4-byte
// store; at the H100's 64 integer lanes an SM and clock the operations take
// several times longer than the bytes.
//
// Design: the plan's work list (DrawPlan builds it once, beside the table)
// cuts every segment into ranges of at most 1,024 elements, the first of
// them the few elements before the segment's output is aligned to four
// elements.  A persistent grid (four blocks an SM) walks it: block b takes a
// contiguous run of ranges, so it touches one to three segments; it derives
// only those segments' keys, one thread a segment, into shared memory beside
// their fields, once.  Then each thread computes four consecutive words of a
// range (four independent threefry chains in registers) and writes them
// with one 16-byte store (8 bytes for bfloat16 masks); a range that is not
// aligned, and the last partial group of a range, store word by word.
// Segments with an index array read their four counters from it.
#include "common.cuh"

namespace {

constexpr int kFields = 16;     // int64 words a segment of the table takes
constexpr int kMaxChain = 8;
constexpr int kMaxSegments = 128;
constexpr int kMaxLanes = 16;
constexpr int kThreads = 256;
constexpr int kVec = 4;         // consecutive words a thread
constexpr int kBlocksPerSm = 4;

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

// A segment's fields and key, as a block holds them in shared memory.
struct Segment {
  unsigned long long offset;        // byte offset of element 0 in the output
  const long long* index;           // counters, or null: the flat index
  uint32_t key0, key1, keep;
  int kind;
};

// A word's output value from its bits, as 32 bits (bfloat16: the low half).
__device__ __forceinline__ uint32_t transform(uint32_t bits, int kind, float keep) {
  if (kind == kBits) return bits;
  if (kind == kSortKey) return bits ^ 0x80000000u;
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  if (kind == kUniform) return __float_as_uint(u);
  const float m = u < keep ? 1.0f : 0.0f;
  if (kind == kMaskF32) return __float_as_uint(m);
  const mmer::bf16 h = __float2bfloat16_rn(m);
  return uint32_t(*reinterpret_cast<const unsigned short*>(&h));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    threefry_kernel(const long long* __restrict__ table, const long long* __restrict__ work,
                    int n_work, Keys keys, int fold_step, uint32_t step,
                    uint8_t* __restrict__ out) {
  __shared__ Segment seg[kMaxSegments];
  // This block's ranges: a contiguous run of the list.
  const int per_block = (n_work + gridDim.x - 1) / gridDim.x;
  const int w0 = blockIdx.x * per_block;
  const int w1 = min(w0 + per_block, n_work);
  if (w0 >= w1) return;
  // Work entry: (begin, segment | count << 32); the list is in segment order.
  const int s0 = int(work[2 * w0 + 1] & 0xffffffff);
  const int s1 = int(work[2 * (w1 - 1) + 1] & 0xffffffff);
  for (int i = threadIdx.x; i <= s1 - s0; i += blockDim.x) {
    const long long* row = table + (s0 + i) * kFields;
    const int lane = int(row[kLane]);
    uint32_t k0 = keys.w[2 * lane], k1 = keys.w[2 * lane + 1];
    if (fold_step) fold_in(k0, k1, step);
    const int len = int(row[kChainLen]);
    for (int c = 0; c < len; ++c) fold_in(k0, k1, uint32_t(row[kChain + c]));
    seg[i].offset = (unsigned long long)row[kOffset];
    seg[i].index = reinterpret_cast<const long long*>(row[kIndex]);
    seg[i].key0 = k0;
    seg[i].key1 = k1;
    seg[i].keep = uint32_t(row[kKeep]);
    seg[i].kind = int(row[kKind]);
  }
  __syncthreads();

  for (int w = w0; w < w1; ++w) {
    const unsigned long long begin = (unsigned long long)work[2 * w];
    const long long packed = work[2 * w + 1];
    const Segment& sg = seg[int(packed & 0xffffffff) - s0];
    const int count = int(packed >> 32);
    // A range holds at most kThreads * kVec elements (ops/prng.py: ITEM):
    // each thread takes one group of kVec.
    const int first = threadIdx.x * kVec;
    if (first >= count) continue;
    const int kind = sg.kind;
    const int esize = kind == kMaskBf16 ? 2 : 4;
    const float keep = __uint_as_float(sg.keep);
    uint32_t v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const unsigned long long i = begin + first + e;
      // A counter past the range's end is computed and not stored.
      const unsigned long long c =
          sg.index ? (unsigned long long)sg.index[first + e < count ? i : begin] : i;
      uint32_t x0 = uint32_t(c >> 32), x1 = uint32_t(c);
      threefry(sg.key0, sg.key1, x0, x1);
      v[e] = transform(x0 ^ x1, kind, keep);
    }
    const unsigned long long byte = sg.offset + (begin + first) * esize;
    uint8_t* dst = out + byte;
    if (first + kVec <= count && byte % (kVec * esize) == 0) {
      if (esize == 4)
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (first + e >= count) break;
        if (esize == 4)
          reinterpret_cast<uint32_t*>(dst)[e] = v[e];
        else
          reinterpret_cast<unsigned short*>(dst)[e] = (unsigned short)v[e];
      }
    }
  }
}

}  // namespace

MMER_EXPORT int mmer_threefry(const void* table, int n_seg, const void* work, int n_work,
                              const void* host_keys, int n_keys, int fold_step,
                              unsigned int step, void* out, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || n_keys < 1 || n_keys > kMaxLanes || n_work < 1)
    return int(cudaErrorInvalidValue);
  const int sms = mmer::sm_count();
  if (sms < 1) return int(cudaErrorInvalidDevice);
  Keys keys = {};
  const uint32_t* words = static_cast<const uint32_t*>(host_keys);
  for (int i = 0; i < 2 * n_keys; ++i) keys.w[i] = words[i];
  const int blocks = n_work < sms * kBlocksPerSm ? n_work : sms * kBlocksPerSm;
  threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), static_cast<const long long*>(work), n_work, keys,
      fold_step, step, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}
