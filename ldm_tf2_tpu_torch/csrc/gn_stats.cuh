// GroupNorm statistics in two fixed-order passes, shared by group_norm.cu
// (the stats kernel and the fused GroupNorm) and gn_silu_conv3x3.cu (the
// chain's first stage).
//
// Layout: x [B, HW, C] (channels last), float32 or bfloat16.
//
//  1. gn_partial_kernel: block (g, b, chunk) sums x and x^2 in float32 over
//     its chunk of the image's positions, for the cg = C / G channels of
//     group g: thread-strided partial sums, then a fixed tree (warp
//     shuffles, then the warps in order).  The caller picks the number of
//     chunks from the shape alone, so the summation order is fixed per
//     shape and the result deterministic.
//  2. gn_finalize_kernel: one thread per (b, channel) adds its group's
//     chunk partials in order, then mean = s1 / n, var = s2 / n - mean^2
//     (clamped at 0 when asked: the chain clamps, the GroupNorm kernels do
//     not, each as its TPU kernel does) and rstd = 1 / sqrt(var + eps), all
//     with explicit round-to-nearest operations.  It writes the per-channel
//     mean and rstd, or rstd * gamma when gamma is given (the factor the
//     normalize step multiplies by).
//  3. gn_normalize_kernel (optional): y = ((x - mean) * factor) + beta, and
//     SiLU when asked, in x's type.
//
// What bounds it on this card: memory (x is read once, 2 float32
// operations an element).  Both TPU kernels hold an image's [HW, C] slab,
// or a block of its rows, in VMEM; here nothing has to fit on chip, so
// every HW streams.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace ldm {

constexpr int kStatsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int hw, int c,
                  int groups, int chunks) {
  __shared__ float red[2][kStatsThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y, chunk = blockIdx.z;
  const int cg = c / groups;
  const int rows = (hw + chunks - 1) / chunks;
  const int r0 = min(chunk * rows, hw), r1 = min(r0 + rows, hw);
  const long n = (long)(r1 - r0) * cg;
  const T* xb = x + ((long)b * hw + r0) * c + (long)g * cg;
  float s1 = 0.f, s2 = 0.f;
  for (long i = threadIdx.x; i < n; i += kStatsThreads) {
    const long row = i / cg;
    const float v = to_f32(xb[row * c + (i - row * cg)]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kStatsThreads / 32; ++w) {  // fixed order
      t1 += red[0][w];
      t2 += red[1][w];
    }
    float* p = partial + (((long)b * groups + g) * chunks + chunk) * 2;
    p[0] = t1;
    p[1] = t2;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ gamma, float* __restrict__ mean,
                                   float* __restrict__ factor, int b_total, int hw, int c,
                                   int groups, int chunks, float eps, int clamp) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)b_total * c) return;
  const int b = (int)(idx / c), ch = (int)(idx % c);
  const int cg = c / groups;
  const float* p = partial + ((long)b * groups + ch / cg) * chunks * 2;
  float s1 = 0.f, s2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    s1 += p[2 * k];
    s2 += p[2 * k + 1];
  }
  const float nf = (float)((long)hw * cg);
  const float m = __fdiv_rn(s1, nf);
  float var = __fsub_rn(__fdiv_rn(s2, nf), __fmul_rn(m, m));
  if (clamp) var = fmaxf(var, 0.f);
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  mean[idx] = m;
  factor[idx] = gamma != nullptr ? __fmul_rn(rstd, gamma[ch]) : rstd;
}

// Both passes: per-channel mean [B, C] and rstd (or rstd * gamma) [B, C].
// partial: B * groups * chunks * 2 floats of scratch.
template <typename T>
cudaError_t gn_stats(const T* x, const float* gamma, float* partial, float* mean,
                     float* factor, int b, int hw, int c, int groups, int chunks, float eps,
                     int clamp, cudaStream_t st) {
  gn_partial_kernel<T><<<dim3(groups, b, chunks), kStatsThreads, 0, st>>>(x, partial, hw, c,
                                                                         groups, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)b * c;
  gn_finalize_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      partial, gamma, mean, factor, b, hw, c, groups, chunks, eps, clamp);
  return cudaGetLastError();
}

// The normalize step of both the fused GroupNorm and the chain's prologue:
// ((x - mean) * factor) + beta, then y * sigmoid(y) when activate, in the
// plain versions' order with explicit round-to-nearest operations.
__device__ __forceinline__ float gn_apply(float xv, float mean, float factor, float beta,
                                          bool activate) {
  float y = __fadd_rn(__fmul_rn(__fsub_rn(xv, mean), factor), beta);
  if (activate) y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
  return y;
}

// y = gn_apply(x) in x's type T, one grid-stride pass: the fused
// GroupNorm's output, and the chain's normalized conv input.
template <typename T>
__global__ void __launch_bounds__(256)
gn_normalize_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ factor, const float* __restrict__ beta,
                    T* __restrict__ y, long hwc, int c, long total, int activate) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int ch = (int)(i % c);
    const long bc = (i / hwc) * c + ch;
    y[i] = from_f32<T>(gn_apply(to_f32(x[i]), mean[bc], factor[bc], beta[ch], activate != 0));
  }
}

template <typename T>
cudaError_t gn_normalize(const T* x, const float* mean, const float* factor, const float* beta,
                         T* y, int b, int hw, int c, int activate, cudaStream_t st) {
  const long total = (long)b * hw * c;
  const long blocks = (total + 255) / 256;
  gn_normalize_kernel<T><<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0, st>>>(
      x, mean, factor, beta, y, (long)hw * c, c, total, activate);
  return cudaGetLastError();
}

}  // namespace ldm
