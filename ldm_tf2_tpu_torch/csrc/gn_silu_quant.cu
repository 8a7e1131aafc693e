// GroupNorm -> SiLU -> per-image symmetric int8 quantization, for Hopper
// (sm_90a): (y8, sa) with y8 * sa[b] ~= silu(group_norm(x)).
//
// Replaces the TPU kernels ldm_tf2_tpu/ops/quant_conv.py::
// _gn_silu_quant_kernel (one image's [HW, C] slab resident in VMEM) and
// _gn_silu_quant_stream_kernel (the same in three passes over HW blocks, for
// slabs VMEM cannot hold).  Here one set of kernels covers every HW: nothing
// has to fit on chip, so the two TPU variants are one.
//
// Layout: x [B, HW, C] (NHWC flattened), float32 or bfloat16; gamma, beta
// [C] float32; y8 [B, HW, C] int8; sa [B] float32.
//
// What bounds it on this card: memory.  It does about 20 operations per
// element against 2 bytes read and 1 written, far below the card's ratio.
// The design reads x three times (stats, amax, quantize) rather than
// keeping y: one pass per reduction that the next pass depends on.
//
//  1. stats: one block per (group, image) sums x and x^2 in float32 in a
//     fixed order (thread-strided partial sums, then a fixed tree), so the
//     statistics are deterministic; fast variance max(E[x^2] - mean^2, 0)
//     as the TPU kernel computes it.  The block of group 0 also zeroes the
//     image's amax.
//  2. amax: elementwise normalize, affine, SiLU; the per-image max |y| is
//     reduced in the block and merged with atomicMax on the float's bits
//     (max is order-free, and non-negative floats order as their bits).
//  3. quantize: the same elementwise y, sa = max(amax, 1e-8) / 127 and
//     y8 = clip(rint(y * (1 / sa)), -127, 127) (round half to even, times
//     the reciprocal, as the TPU kernel does).
//
// Passes 2 and 3 compute y with the same function and explicit
// round-to-nearest operations, in the plain version's order:
// ((x - mean) * (rstd * gamma)) + beta, then y * sigmoid(y).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];  // fixed order
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, unsigned* __restrict__ amax,
                int hw, int c, int groups, float eps) {
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = c / groups;
  const long n = (long)hw * cg;
  const T* xb = x + (long)b * hw * c + (long)g * cg;
  float s1 = 0.f, s2 = 0.f;
  for (long i = threadIdx.x; i < n; i += kThreads) {
    const long row = i / cg;
    const float v = to_f32(xb[row * c + (i - row * cg)]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    const float nf = (float)n;
    const float mean = __fdiv_rn(s1, nf);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, nf), __fmul_rn(mean, mean)), 0.f);
    stats[(b * groups + g) * 2] = mean;
    stats[(b * groups + g) * 2 + 1] = 1.f / sqrtf(var + eps);
    if (g == 0) amax[b] = 0u;
  }
}

// silu(group_norm(x)) for element (b, ch) of value xv.
__device__ __forceinline__ float gn_silu(float xv, const float* st, const float* __restrict__ gamma,
                                         const float* __restrict__ beta, int ch, int cg) {
  const float mean = st[(ch / cg) * 2], rstd = st[(ch / cg) * 2 + 1];
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(xv, mean), __fmul_rn(rstd, gamma[ch])), beta[ch]);
  return __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_amax_kernel(const T* __restrict__ x, const float* __restrict__ stats,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               unsigned* __restrict__ amax, int hw, int c, int groups) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.y;
  const long n = (long)hw * c;
  const T* xb = x + (long)b * n;
  const float* st = stats + (long)b * groups * 2;
  const int cg = c / groups;
  float m = 0.f;
  const long base = (long)blockIdx.x * kThreads * kItemsPerThread + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const long i = base + (long)k * kThreads;
    if (i < n) m = fmaxf(m, fabsf(gn_silu(to_f32(xb[i]), st, gamma, beta, (int)(i % c), cg)));
  }
  m = warp_max(m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
    atomicMax(amax + b, __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_quant_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const unsigned* __restrict__ amax, int8_t* __restrict__ y8,
                float* __restrict__ sa, int hw, int c, int groups) {
  const int b = blockIdx.y;
  const long n = (long)hw * c;
  const T* xb = x + (long)b * n;
  int8_t* yb = y8 + (long)b * n;
  const float* st = stats + (long)b * groups * 2;
  const int cg = c / groups;
  const float scale = __fmul_rn(fmaxf(__uint_as_float(amax[b]), 1e-8f), 1.f / 127.f);
  const float inv = __frcp_rn(scale);
  if (blockIdx.x == 0 && threadIdx.x == 0) sa[b] = scale;
  const long base = (long)blockIdx.x * kThreads * kItemsPerThread + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const long i = base + (long)k * kThreads;
    if (i < n) {
      const float y = gn_silu(to_f32(xb[i]), st, gamma, beta, (int)(i % c), cg);
      yb[i] = (int8_t)fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.f), 127.f);
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const float* gamma, const float* beta, int8_t* y8, float* sa,
                float* stats, unsigned* amax, int b, int hw, int c, int groups, float eps,
                cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  gn_stats_kernel<T><<<dim3(groups, b), kThreads, 0, st>>>(xt, stats, amax, hw, c, groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = (long)hw * c;
  const dim3 grid((unsigned)((n + kThreads * kItemsPerThread - 1) / (kThreads * kItemsPerThread)),
                  b);
  gn_amax_kernel<T><<<grid, kThreads, 0, st>>>(xt, stats, gamma, beta, amax, hw, c, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_quant_kernel<T><<<grid, kThreads, 0, st>>>(xt, stats, gamma, beta, amax, y8, sa, hw, c,
                                                groups);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16 x, 0
// for float32.  Scratch: stats [B, groups, 2] float32, amax [B] uint32.  The
// caller checks shapes (c % groups == 0).
extern "C" int ldm_gn_silu_quant(const void* x, const void* gamma, const void* beta, void* y8,
                                 void* sa, void* stats, void* amax, int b, int hw, int c,
                                 int groups, float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  int8_t* y = static_cast<int8_t*>(y8);
  float* s = static_cast<float*>(sa);
  float* stt = static_cast<float*>(stats);
  unsigned* am = static_cast<unsigned*>(amax);
  cudaError_t err = is_bf16 ? run<bf16>(x, g, be, y, s, stt, am, b, hw, c, groups, eps, st)
                            : run<float>(x, g, be, y, s, stt, am, b, hw, c, groups, eps, st);
  return static_cast<int>(err);
}
