// One Wav2Vec2 feature-encoder layer: VALID 1-D conv as a GEMM, + bias,
// LayerNorm over the 512 channels, exact-erf GELU, bf16 out.
//
// Replaces the Pallas kernel mmer_tpu/ops/conv_pyramid.py:_mega_kernel
// (fused_conv_encoder(mega=True)); the Python wrapper launches this kernel
// once per layer.  Same numerics as that kernel's _epilogue: the input is
// rounded to bf16 (the f32 waveform for layer 0), the conv accumulates in
// f32 and is rounded to bf16, the bias is added in bf16, LayerNorm runs in
// f32 (flax: eps 1e-6, var = max(0, E[x^2] - E[x]^2)) and is rounded to
// bf16, GELU runs in f32 and is rounded to bf16.
//
// What bounds it on the H100: the k3/k2 layers are tensor-core GEMMs
// (K = 1536 or 1024, N = 512) with the activation read once and written
// once; layer 0 (10 taps on one channel) is bound by writing its
// (T, 512) bf16 output.  Design: because every output frame t reads the
// contiguous input rows [s*t, s*t + k), row t of the conv's im2col matrix is
// one contiguous stretch of the (T_in, C_in) activation starting at
// s*t*C_in; a block stages 32 such rows x 64 taps at a time in shared memory
// (no patch matrix ever reaches device memory) and multiplies them with WMMA
// 16x16x16 bf16 tiles against the (512, K) weight read straight from global
// memory.  The block holds all 512 channels of its 32 frames, so the
// LayerNorm is block-local.  The TPU kernel's 64-way phase-split layout
// worked around a Mosaic relayout and does not carry over; fusing the whole
// pyramid into one launch is later work.
#include "common.cuh"

namespace {

using mmer::bf16;
using namespace nvcuda;

constexpr int C = 512;        // output channels
constexpr int BT = 32;        // output frames per block
constexpr int KC = 64;        // taps staged per step
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int LDA = KC + 8;   // bf16 row stride of the staged im2col rows
constexpr int LDY = C + 4;    // f32 row stride of the conv output tile
constexpr int NT = (C / 4) / 16;  // col tiles per warp: 4 column groups x 2 row tiles

constexpr size_t SMEM_BYTES =
    size_t(BT) * LDA * sizeof(bf16) + size_t(BT) * LDY * sizeof(float);

template <typename IT>
__global__ void __launch_bounds__(NTHREAD)
conv_ln_gelu_kernel(const IT* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ cb, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, bf16* __restrict__ out, int t_in,
                    int t_out, int c_in, int k, int stride, int kp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  float* ys = reinterpret_cast<float*>(smem + size_t(BT) * LDA * sizeof(bf16));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BT;
  const IT* xb = x + size_t(blockIdx.y) * t_in * c_in;
  const int kfull = k * c_in;
  const int rt = warp & 1;                 // 16-row tile of this warp
  const int col0 = (warp >> 1) * (C / 4);  // first output channel of this warp

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < kp; k0 += KC) {
    const int kc = min(KC, kp - k0);  // a multiple of 16
    __syncthreads();
    for (int i = tid; i < BT * KC; i += NTHREAD) {
      const int r = i / KC, c = i % KC;
      const int t = t0 + r, kk = k0 + c;
      float val = 0.f;
      if (c < kc && t < t_out && kk < kfull)
        val = mmer::to_f32(xb[size_t(t) * stride * c_in + kk]);
      as[r * LDA + c] = __float2bfloat16_rn(val);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, as + rt * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w + size_t(col0 + j * 16) * kp + k0 + kk, kp);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(ys + rt * 16 * LDY + col0 + j * 16, acc[j], LDY,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue, one warp per frame row: each lane holds 16 of the 512 channels.
  for (int r = warp; r < BT; r += NWARP) {
    const int t = t0 + r;
    if (t >= t_out) continue;
    float y[C / 32];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      y[i] = mmer::round_bf16(mmer::round_bf16(ys[r * LDY + c]) + mmer::round_bf16(cb[c]));
      s += y[i];
      ss += y[i] * y[i];
    }
    s = mmer::warp_sum(s);
    ss = mmer::warp_sum(ss);
    const float mean = s / C;
    const float var = fmaxf(ss / C - mean * mean, 0.f);
    const float rstd = 1.0f / sqrtf(var + 1e-6f);
    bf16* dst = out + (size_t(blockIdx.y) * t_out + t) * C;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      const float ln = mmer::round_bf16((y[i] - mean) * rstd * ln_w[c] + ln_b[c]);
      dst[c] = __float2bfloat16_rn(mmer::gelu_erf(ln));
    }
  }
}

template <typename IT>
int launch(const void* x, const void* w, const void* cb, const void* ln_w,
           const void* ln_b, void* out, int batch, int t_in, int t_out, int c_in,
           int k, int stride, int kp, cudaStream_t stream) {
  auto kern = conv_ln_gelu_kernel<IT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  dim3 grid((t_out + BT - 1) / BT, batch);
  kern<<<grid, NTHREAD, SMEM_BYTES, stream>>>(
      static_cast<const IT*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(cb), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), t_in, t_out, c_in, k,
      stride, kp);
  return int(cudaGetLastError());
}

}  // namespace

// x: (batch, t_in, c_in) contiguous, f32 (x_is_f32 = 1, the layer-0
// waveform with c_in = 1) or bf16; w: (512, kp) bf16, the conv weight as
// (out, k, c_in) flattened and zero-padded to kp, a multiple of 16;
// cb, ln_w, ln_b: (512,) f32; out: (batch, t_out, 512) bf16.
MMER_EXPORT int mmer_conv_ln_gelu(const void* x, const void* w, const void* cb,
                                  const void* ln_w, const void* ln_b, void* out,
                                  int batch, int t_in, int t_out, int c_in, int c_out,
                                  int k, int stride, int kp, int x_is_f32,
                                  void* stream) {
  if (c_out != C || kp % 16 != 0 || kp < k * c_in || t_out <= 0 || batch <= 0 ||
      (t_out - 1) * stride + k > t_in)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_f32
             ? launch<float>(x, w, cb, ln_w, ln_b, out, batch, t_in, t_out, c_in, k, stride, kp, s)
             : launch<bf16>(x, w, cb, ln_w, ln_b, out, batch, t_in, t_out, c_in, k, stride, kp, s);
}
