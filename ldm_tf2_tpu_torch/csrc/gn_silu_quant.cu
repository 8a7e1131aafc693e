// GroupNorm -> SiLU -> per-image symmetric int8 quantization, for Hopper
// (sm_90a): (y8, sa) with y8 * sa[b] ~= silu(group_norm(x)).
//
// Replaces the TPU kernels ldm_tf2_tpu/ops/quant_conv.py::
// _gn_silu_quant_kernel (one image's [HW, C] slab resident in VMEM, one
// pass) and _gn_silu_quant_stream_kernel (the same in three passes over HW
// blocks, for slabs VMEM cannot hold).  Both are one kernel here, one launch
// per call on a thread-block cluster per image (gn_cluster.cuh): the
// cluster's CTAs hold the image's slab in their shared memory where it fits
// (resident mode; every serving shape) and read the rest of their rows
// again from device memory where it does not (re-read mode; the TPU's
// streamed class).
//
// Layout: x [B, HW, C] (NHWC flattened), float32 or bfloat16; gamma, beta
// [C] float32; y8 [B, HW, C] int8; sa [B] float32.
//
// What bounds it on this card: at the serving shapes the SMs' instruction rate
// and the load of x, not the memory rate.  It moves 3 bytes an element (x
// read, codes written) against about 25 float32 operations (y with an exp
// and a correctly rounded reciprocal, then the code), and one cluster per
// image caps a batch of 8 at 64 of the 132 SMs.
//
//  1. statistics: per-channel float32 sums of the CTA's rows, per group,
//     then across the cluster in rank order; fast variance max(E[x^2] -
//     mean^2, 0) as the TPU kernel computes it;
//  2. amax = max |y| over the image, y = silu(((x - mean) * (rstd * gamma))
//     + beta): from each channel's extreme x where that is exact (see the
//     kernel), else a pass over the elements; ranks reduced after a cluster
//     barrier;
//  3. codes: sa = max(amax, 1e-8) * (1 / 127) and y8 = clip(rint(y * (1 /
//     sa)), -127, 127) (round half to even, times the reciprocal, as the
//     TPU kernel does), y with explicit round-to-nearest operations and no
//     contraction, so it has the bits the amax saw; W codes a store (8
//     bytes for bf16, 4 for float32: a warp writes 256 or 128 contiguous
//     bytes of a row).  Rank 0 writes sa.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "gn_cluster.cuh"

namespace {

using namespace ldm;
using gnc::Geometry;

constexpr float kRoundToInt = 12582912.f;  // 1.5 * 2^23: x + it rounds x to an integer
// Above |silu(z)| for every float z < 0 (its least value is about -0.27846,
// at z = -1.2785; ldm_gn_silu_checks holds the bound on every negative float)
constexpr float kNegBound = 0.2785f;

// The code of y: clip first (the bounds are integers, so clip(rint(v)) ==
// rint(clip(v))), then round half to even by the add; the low byte of the
// sum's bits is the code in two's complement.
__device__ __forceinline__ uint32_t code_of(float y, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(v, kRoundToInt)) & 0xffu;
}

// The cluster's maximum of every thread's m: the CTA's in s.amax[slot],
// then, after a cluster barrier, the ranks' (max is order-free).
__device__ __forceinline__ float cluster_max(float m, const gnc::Smem& s, int slot,
                                             const Geometry& g) {
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) s.wred[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = s.wred[0];
    for (int w = 1; w < (int)blockDim.x / 32; ++w) t = fmaxf(t, s.wred[w]);
    s.amax[slot] = t;
  }
  gnc::cluster_sync();
  float a = 0.f;
#pragma unroll
  for (int r = 0; r < gnc::kMaxCluster; ++r)
    if (r < g.cluster) a = fmaxf(a, *gnc::remote(&s.amax[slot], r));
  return a;
}

// One cluster per image (grid (R, 1, B)).  The amax: for z >= 0 the
// computed silu is non-decreasing (expf is monotone there and the rest are
// correctly rounded operations; ldm_gn_silu_checks holds expf on every
// float of [-104, 0]), and z = ((x - mean) * factor) + beta is monotone in
// x, so a channel's largest y >= 0 is at its largest x (smallest where
// factor < 0): the CTA's candidate is the max of y at those extremes.  Where
// the cluster's candidate reaches kNegBound it is max |y| exactly, as no y <
// 0 gets that far; else (every rank alike) a pass over the elements takes
// max |y| itself.
template <typename T, int W>
__global__ void __launch_bounds__(gnc::kMaxThreads, 1)
gn_silu_quant_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                             const float* __restrict__ beta, int8_t* __restrict__ y8,
                             float* __restrict__ sa, int hw, int c, int groups, float eps,
                             Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const gnc::Smem s = gnc::carve(smem, g, c, sizeof(T), true);
  const int rank = gnc::rank(), b = blockIdx.z, cg = c / groups;
  const int r0 = rank * g.rows, nrows = min(g.rows, hw - r0);
  const T* xs = x + ((long)b * hw + r0) * c;
  int8_t* ys = y8 + ((long)b * hw + r0) * c;

  gnc::slice_sums<T, W, true>(xs, c, nrows, g, c, cg, s);
  gnc::cluster_sync();  // every rank's group sums written
  gnc::finish_groups(g, s, (float)((long)hw * cg), eps, /*clamp=*/true);

  float m = 0.f;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    if (!(s.xlo[ch] <= s.xhi[ch])) continue;  // no number in the channel
    const int gi = ch / cg;
    const float factor = __fmul_rn(s.gstat[2 * gi + 1], gamma[ch]);
    const float top = factor >= 0.f ? s.xhi[ch] : s.xlo[ch];
    m = fmaxf(m, gn_apply(top, s.gstat[2 * gi], factor, beta[ch], true));
  }
  float amax = cluster_max(m, s, 0, g);
  gnc::Affine<W> a;
  auto begin = [&](int v) { a = gnc::affine<W>(v, cg, gamma, beta, s); };
  if (amax < kNegBound) {
    m = 0.f;
    gnc::each_row<T, W>(xs, c, nrows, g, c, s, begin, [&](int, int, const float(&xv)[W]) {
      float y[W];
      gnc::silu_vec<W>(xv, a, y);
#pragma unroll
      for (int e = 0; e < W; ++e) m = fmaxf(m, fabsf(y[e]));
    });
    amax = cluster_max(m, s, 1, g);
  }
  gnc::cluster_arrive();  // done with the other ranks' shared memory
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), 1.f / 127.f);
  const float inv = __frcp_rn(scale);
  if (rank == 0 && threadIdx.x == 0) sa[b] = scale;

  gnc::each_row<T, W>(xs, c, nrows, g, c, s, begin, [&](int r, int v, const float(&xv)[W]) {
    float y[W];
    gnc::silu_vec<W>(xv, a, y);
    uint32_t q[W];
#pragma unroll
    for (int e = 0; e < W; ++e) q[e] = code_of(y[e], inv);
    int8_t* dst = ys + (long)r * c + v * W;
    if constexpr (W == 1) {
      *dst = (int8_t)q[0];
    } else {
      uint32_t word[W / 4];
#pragma unroll
      for (int k = 0; k < W / 4; ++k)
        word[k] = __byte_perm(__byte_perm(q[4 * k], q[4 * k + 1], 0x0040),
                              __byte_perm(q[4 * k + 2], q[4 * k + 3], 0x0040), 0x5410);
      if constexpr (W == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = word[0];
      }
    }
  });
  gnc::cluster_wait();  // no rank exits while another may read its maxima
}

// The arithmetic facts the kernel rests on, counted over every float of
// their range: out[0], rcp_from1 against __frcp_rn on [1, 2^126); out[1],
// steps of [-104, 0] where expf decreases; out[2], floats z < 0 where
// |silu(z)| >= kNegBound.  Each must be 0.
__global__ void silu_checks_kernel(unsigned long long* out) {
  const uint64_t step = (uint64_t)gridDim.x * blockDim.x;
  const uint64_t first = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long bad[3] = {0, 0, 0};
  for (uint64_t u = 0x3F800000u + first; u < 0x7E800000u; u += step) {
    const float d = __uint_as_float((uint32_t)u);
    bad[0] += __float_as_uint(gnc::rcp_from1(d)) != __float_as_uint(__frcp_rn(d));
  }
  for (uint64_t u = 0x80000000u + first; u < 0xC2D00000u; u += step)
    bad[1] += expf(__uint_as_float((uint32_t)u + 1)) > expf(__uint_as_float((uint32_t)u));
  for (uint64_t u = 0x80000001u + first; u < 0xFF800000u; u += step) {
    const float z = __uint_as_float((uint32_t)u);
    bad[2] += !(fabsf(gn_apply(z, 0.f, 1.f, 0.f, true)) < kNegBound);
  }
  for (int k = 0; k < 3; ++k)
    if (bad[k]) atomicAdd(&out[k], bad[k]);
}

template <typename T>
cudaError_t run(const void* x, const float* gamma, const float* beta, int8_t* y8, float* sa,
                int b, int hw, int c, int groups, float eps, const Geometry& g,
                cudaStream_t st) {
  if (!gnc::geometry_ok(g, hw, c, groups, sizeof(T), true) || g.gps != groups)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  if (g.vec > 1) {
    if (!aligned16(xt) || !aligned16(y8)) return cudaErrorInvalidValue;
    return gnc::launch(gn_silu_quant_cluster_kernel<T, (int)(16 / sizeof(T))>, g, 1, b, st, xt,
                       gamma, beta, y8, sa, hw, c, groups, eps, g);
  }
  return gnc::launch(gn_silu_quant_cluster_kernel<T, 1>, g, 1, b, st, xt, gamma, beta, y8, sa,
                     hw, c, groups, eps, g);
}

Geometry geometry_of(const int* geo) {
  return Geometry{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], geo[7], geo[8]};
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16 x, 0
// for float32.  geometry: ops/quant_conv.py::gn_cluster_plan's nine ints
// {cluster, rows, keep, gps, vec, cols, phases, threads, smem} for this
// shape (gps == groups), checked here; vec > 1 needs 16-byte aligned x and
// y8.  One launch, no scratch.
extern "C" int ldm_gn_silu_quant(const void* x, const void* gamma, const void* beta, void* y8,
                                 void* sa, int b, int hw, int c, int groups, float eps,
                                 int is_bf16, const int* geometry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry_of(geometry);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  int8_t* y = static_cast<int8_t*>(y8);
  float* s = static_cast<float*>(sa);
  cudaError_t err = is_bf16 ? run<bf16>(x, ga, be, y, s, b, hw, c, groups, eps, g, st)
                            : run<float>(x, ga, be, y, s, b, hw, c, groups, eps, g, st);
  return static_cast<int>(err);
}

// The most clusters of this geometry the card holds at once, in *out (0:
// the launch cannot run); a cudaError_t value.
extern "C" int ldm_gn_silu_quant_clusters(int b, int is_bf16, const int* geometry, int* out) {
  const Geometry g = geometry_of(geometry);
  cudaError_t err;
  if (is_bf16)
    err = g.vec > 1 ? gnc::max_clusters(gn_silu_quant_cluster_kernel<bf16, 8>, g, 1, b, out)
                    : gnc::max_clusters(gn_silu_quant_cluster_kernel<bf16, 1>, g, 1, b, out);
  else
    err = g.vec > 1 ? gnc::max_clusters(gn_silu_quant_cluster_kernel<float, 4>, g, 1, b, out)
                    : gnc::max_clusters(gn_silu_quant_cluster_kernel<float, 1>, g, 1, b, out);
  return static_cast<int>(err);
}

// out: 3 unsigned 64-bit counts on the device (silu_checks_kernel), set to
// 0 here; a cudaError_t value.
extern "C" int ldm_gn_silu_checks(void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, 3 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  silu_checks_kernel<<<132 * 8, 256, 0, st>>>(o);
  return static_cast<int>(cudaGetLastError());
}
