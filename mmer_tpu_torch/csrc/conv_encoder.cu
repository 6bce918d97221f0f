// One Wav2Vec2 feature-encoder layer: VALID 1-D conv as a GEMM, + bias,
// LayerNorm over the 512 channels, exact-erf GELU, bf16 out.
//
// Replaces the Pallas kernel mmer_tpu/ops/conv_pyramid.py:_mega_kernel (:278,
// fused_conv_encoder(mega=True)); the Python wrapper launches one kernel of
// this file per layer.  Same numerics as that kernel's _epilogue: the input is
// rounded to bf16 (the f32 waveform for layer 0), the conv accumulates in f32
// and is rounded to bf16, the bias is added in bf16, LayerNorm runs in f32
// (flax: eps 1e-6, var = max(0, E[x^2] - E[x]^2)) and is rounded to bf16,
// GELU runs in f32 and is rounded to bf16.  The TPU kernel's 64-way
// phase-split layout worked around a Mosaic relayout and does not carry over.
//
// What bounds each layer type on the H100, and the design:
//   - kernel-3 and kernel-2 layers (K = 1536 / 1024, N = 512): tensor-core
//     operations (512 / 341 FLOP a byte of activation read and written, above
//     the card's ~295).  conv_ln_gelu_kernel is the body of conv_tile.cuh:
//     im2col row t is the contiguous stretch of the (T_in, C_in) activation at
//     s*t*C_in, so 64 rows x 64 k of it and 512 channels x 64 k of the
//     K-major (512, kp) weight go by cp.async through a three-stage ring in
//     shared memory, wgmma m64n256k16 products accumulate in registers, and
//     the epilogue runs on the accumulators.  L2 bandwidth caps it (57 FLOP a
//     staged byte; conv_tile.cuh);
//   - layer 0 (10 taps of one f32 channel, stride 5): bytes by the card's
//     rates, the (T, 512) bf16 output (1.05 GB at (64, 80000), 0.31 ms at
//     3.35 TB/s), but ~40 instructions an output (10 FMAs, the roundings,
//     the LayerNorm and an exact erf), ~0.8 ms of instructions at that shape.
//     Tensor cores buy nothing there: conv0_ln_gelu_kernel computes each
//     output as 10 FMAs on bf16-rounded operands with f32 sums on the CUDA
//     cores, the block's waveform window and the weight staged once in
//     shared memory, and runs the epilogue from registers a warp a row (32
//     sums a thread, 80 registers, three blocks an SM to hide latency).  The
//     wgmma body's epilogue would hold 128 sums a thread and one block an SM,
//     which hid no latency here (2.01 ms against 1.29 ms at (64, 80000) on
//     an H100 SXM).
#include "conv_tile.cuh"

namespace {

using mmer::bf16;
namespace conv = mmer::conv;

constexpr int KMAX = 16;      // layer-0 taps (k * c_in) the CUDA-core path takes

// A kernel-3 (K = 3) or kernel-2 (K = 2) stride-2 layer over a bf16
// activation of 512 channels: im2col rows of K * 512 values, ROW_STRIDE apart.
template <int K>
__global__ void __launch_bounds__(conv::NTHREAD, 1)
conv_ln_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ cb, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, bf16* __restrict__ out, int t_in,
                    int t_out) {
  constexpr int KP = K * conv::C;
  extern __shared__ unsigned char smem_raw[];
  const conv::Shared sm = conv::carve(smem_raw);
  const int tid = threadIdx.x, t0 = blockIdx.x * conv::BM;
  const int limit = t_in * conv::C;
  conv::stage_vectors(sm.vs, cb, ln_w, ln_b, tid);

  float acc[128];
  conv::mainloop<0, KP / conv::KC>(
      acc, sm.ring, x + size_t(blockIdx.y) * limit, limit, t0, t_out,
      [&](uint32_t dst, int step) { conv::load_b_kmajor<KP>(dst, w, step * conv::KC, tid); },
      tid);
  conv::bias_ln_gelu_store(acc, sm.stats, sm.vs, out + size_t(blockIdx.y) * t_out * conv::C,
                           t0, t_out, tid);
}

// Shared memory of the layer-0 kernel: the weight as f32 (kdim x 512, tap
// major), the block's window of input values, the epilogue's vectors.
size_t conv0_smem(int kdim, int window) {
  return size_t(kdim) * conv::C * 4 + size_t(window + 3) / 4 * 16 + conv::VEC_BYTES;
}

// Rows a warp of the layer-0 kernel computes together.
constexpr int L0_PAIR = 2;

// Layer 0 over the f32 waveform (any c_in, k * c_in <= KMAX) on the CUDA
// cores: output (t, n) = sum over tap i of bf16(x[s t c_in + i]) bf16(w[n, i]),
// in f32, tap by tap.  Warp w takes rows 8w .. 8w + 7 of the block's 64, two
// at a time; lane l holds channels 128 g + 4 l + e (g, e < 4) of both rows
// in registers, so the weight is read as four conflict-free float4 a tap and
// the LayerNorm statistics are a warp's sum (per lane in (g, e) order, then
// the xor butterfly of warp_sum).
__global__ void __launch_bounds__(conv::NTHREAD, 3)
conv0_ln_gelu_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ cb, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, bf16* __restrict__ out, int t_in,
                     int t_out, int c_in, int k, int stride, int kp) {
  extern __shared__ __align__(16) float smem_f[];
  const int kdim = k * c_in, row_stride = stride * c_in;
  const int window = (conv::BM - 1) * row_stride + kdim;
  float* ws = smem_f;                                  // [tap][channel]
  float* xs = ws + kdim * conv::C;
  float* vs = xs + (window + 3) / 4 * 4;
  const int tid = threadIdx.x, t0 = blockIdx.x * conv::BM;
  const long long limit = (long long)t_in * c_in;
  const float* xb = x + size_t(blockIdx.y) * limit;
  const long long start = (long long)t0 * row_stride;

  // The weight in 16-byte rows of 8 taps (kp is a multiple of 16), each
  // spread over its taps' rows of ws.
  for (int i = tid; i < conv::C * kp / 8; i += conv::NTHREAD) {
    const int n = i / (kp / 8), tap0 = i % (kp / 8) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(w + size_t(i) * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (tap0 + t < kdim) ws[(tap0 + t) * conv::C + n] = __bfloat162float(e[t]);
  }
  for (int i = tid; i < window; i += conv::NTHREAD)
    xs[i] = start + i < limit ? mmer::round_bf16(xb[start + i]) : 0.f;
  conv::stage_vectors(vs, cb, ln_w, ln_b, tid);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const float4* ws4 = reinterpret_cast<const float4*>(ws) + lane;
  bf16* ob = out + size_t(blockIdx.y) * t_out * conv::C;
#pragma unroll 1
  for (int r0 = warp * (conv::BM / 8); r0 < (warp + 1) * (conv::BM / 8) && t0 + r0 < t_out;
       r0 += L0_PAIR) {
    float acc[L0_PAIR][16];
#pragma unroll
    for (int i = 0; i < L0_PAIR; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int tap = 0; tap < kdim; ++tap) {
      float xv[L0_PAIR];
#pragma unroll
      for (int i = 0; i < L0_PAIR; ++i) xv[i] = xs[(r0 + i) * row_stride + tap];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 wv = ws4[tap * (conv::C / 4) + 32 * g];
#pragma unroll
        for (int i = 0; i < L0_PAIR; ++i) {
          acc[i][4 * g] = fmaf(xv[i], wv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(xv[i], wv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(xv[i], wv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(xv[i], wv.w, acc[i][4 * g + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < L0_PAIR; ++i)
      conv::lane_bias_ln_gelu_store(acc[i], vs, ob + size_t(t0 + r0 + i) * conv::C, lane,
                                    t0 + r0 + i < t_out);
  }
}

}  // namespace

// x: (batch, t_in, c_in) contiguous, f32 (x_is_f32 = 1, the layer-0
// waveform, k * c_in <= 16) or bf16 (c_in = 512, stride 2, k = 2 or 3); w:
// (512, kp) bf16, the conv weight as (out, k, c_in) flattened and
// zero-padded to kp, a multiple of 16 (kp = k * c_in for bf16 x); cb, ln_w,
// ln_b: (512,) f32; out: (batch, t_out, 512) bf16.  grid (host, two ints):
// the grid launched, x then y.
MMER_EXPORT int mmer_conv_ln_gelu(const void* x, const void* w, const void* cb,
                                  const void* ln_w, const void* ln_b, void* out,
                                  int batch, int t_in, int t_out, int c_in, int c_out,
                                  int k, int stride, int kp, int x_is_f32,
                                  void* stream, int* grid) {
  if (c_out != conv::C || kp % 16 != 0 || kp < k * c_in || t_out <= 0 || batch <= 0 ||
      (t_out - 1) * stride + k > t_in || (long long)t_in * c_in >= (1LL << 30))
    return int(cudaErrorInvalidValue);
  const dim3 g = conv::grid_of(t_out, batch);
  grid[0] = int(g.x);
  grid[1] = int(g.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cbf = static_cast<const float*>(cb);
  const float* lwf = static_cast<const float*>(ln_w);
  const float* lbf = static_cast<const float*>(ln_b);
  if (x_is_f32) {
    if (k * c_in > KMAX) return int(cudaErrorInvalidValue);
    const size_t smem =
        conv0_smem(k * c_in, (conv::BM - 1) * stride * c_in + k * c_in);
    cudaError_t err = cudaFuncSetAttribute(
        conv0_ln_gelu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    conv0_ln_gelu_kernel<<<g, conv::NTHREAD, smem, s>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(w), cbf, lwf, lbf,
        static_cast<bf16*>(out), t_in, t_out, c_in, k, stride, kp);
    return int(cudaGetLastError());
  }
  if (c_in != conv::C || stride != 2 || kp != k * c_in || (k != 2 && k != 3))
    return int(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  return int(k == 3 ? conv::launch(conv_ln_gelu_kernel<3>, t_out, batch, s, xb, wb, cbf, lwf, lbf,
                                   ob, t_in, t_out)
                    : conv::launch(conv_ln_gelu_kernel<2>, t_out, batch, s, xb, wb, cbf, lwf, lbf,
                                   ob, t_in, t_out));
}
