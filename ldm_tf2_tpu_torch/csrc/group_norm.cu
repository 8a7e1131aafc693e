// GroupNorm for Hopper (sm_90a): the statistics alone, and the whole
// GroupNorm (+ SiLU).
//
// Replaces two TPU kernels of ldm_tf2_tpu/ops/group_norm.py:
//  * _gn_stats_kernel (through _pallas_group_stats): per-channel mean and
//    rstd = rsqrt(E[x^2] - mean^2 + eps) over HW blocks; the normalize
//    stays outside (ldm_group_stats, one launch: gn_stats.cuh);
//  * _gn_kernel (through _pallas_group_norm): stats, normalize, affine
//    (x - mean) * (rstd * gamma) + beta, optional SiLU, result in x's type
//    (ldm_group_norm, one launch on a thread-block cluster: gn_cluster.cuh).
// Neither clamps the variance, as neither TPU kernel does.
//
// Layout: x, y [B, HW, C] (channels last), float32 or bfloat16; gamma, beta
// [C] float32; mean, rstd [B, C] float32.
//
// What bounds the fused GroupNorm on this card: memory (x read once, y
// written once; about 6 float32 operations an element, 20 with the SiLU).
// The TPU kernel reads one image's [HW, C] slab into VMEM once; here a
// cluster of up to 8 CTAs holds one image's slice of gps groups in shared
// memory (slices of whole groups are independent, so a batch of 4 still
// gets about 128 CTAs), sums it, reduces the groups across the cluster in
// rank order and normalizes from shared memory, writing y with 16-byte
// stores.  A slice larger than the cluster's shared memory (the
// autoencoder's 256^2 maps) keeps what fits and reads the rest again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gn_cluster.cuh"
#include "gn_stats.cuh"

namespace {

using namespace ldm;
using gnc::Geometry;

// At most 256 threads and 113 KB of shared memory a CTA (the plan's), so
// that two share an SM: the card holds 15 clusters of 8 one-CTA SMs, and a
// batch of 4 in 4 slices needs 16.
constexpr int kThreads = 256;

// Grid (R, groups / gps, B), clusters of R along x: CTA (rank, slice, b)
// normalizes rows [rank * rows, ...) of channels [slice * gps * cg, ...) of
// image b.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2)
gn_cluster_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y, int hw, int c,
                       int groups, float eps, int activate, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cg = c / groups, cw = g.gps * cg;
  const gnc::Smem s = gnc::carve(smem, g, cw, sizeof(T), false);
  const int rank = gnc::rank(), b = blockIdx.z, c0 = blockIdx.y * cw;
  const int r0 = rank * g.rows, nrows = min(g.rows, hw - r0);
  const long base = ((long)b * hw + r0) * c + c0;
  const T* xs = x + base;
  T* ys = y + base;

  gnc::slice_sums<T, W, false>(xs, c, nrows, g, cw, cg, s);
  gnc::cluster_sync();  // every rank's group sums written
  gnc::finish_groups(g, s, (float)((long)hw * cg), eps, /*clamp=*/false);
  gnc::cluster_arrive();  // done with the other ranks' shared memory

  gnc::Affine<W> a;
  gnc::each_row<T, W>(
      xs, c, nrows, g, cw, s, [&](int v) { a = gnc::affine<W>(v, cg, gamma + c0, beta + c0, s); },
      [&](int r, int v, const float(&xv)[W]) {
        float out[W];
        if (activate) {
          gnc::silu_vec<W>(xv, a, out);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e)
            out[e] = gn_apply(xv[e], a.mean[e], a.factor[e], a.beta[e], false);
        }
        *reinterpret_cast<gnc::Raw<T, W>*>(ys + (long)r * c + v * W) = gnc::pack<T, W>(out);
      });
  gnc::cluster_wait();  // no rank exits while another may read its sums
}

template <typename T>
cudaError_t group_norm(const void* x, const float* gamma, const float* beta, void* y, int b,
                       int hw, int c, int groups, float eps, int activate, const Geometry& g,
                       cudaStream_t st) {
  if (!gnc::geometry_ok(g, hw, c, groups, sizeof(T), false) || g.threads > kThreads)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int slices = groups / g.gps;
  if (g.vec > 1) {
    if (!aligned16(xt) || !aligned16(yt)) return cudaErrorInvalidValue;
    return gnc::launch(gn_cluster_norm_kernel<T, (int)(16 / sizeof(T))>, g, slices, b, st, xt,
                       gamma, beta, yt, hw, c, groups, eps, activate, g);
  }
  return gnc::launch(gn_cluster_norm_kernel<T, 1>, g, slices, b, st, xt, gamma, beta, yt, hw, c,
                     groups, eps, activate, g);
}

Geometry geometry_of(const int* geo) {
  return Geometry{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], geo[7], geo[8]};
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16 x,
// 0 for float32.  out: [2, B, C] float32, mean then rstd.  chunks, gps,
// vec: the launch grid (gn_stats.cuh); partial, tickets: the persistent
// workspace it needs when chunks > 1.  The caller checks shapes
// (c % groups == 0).
extern "C" int ldm_group_stats(const void* x, void* out, void* partial, void* tickets, int b,
                               int hw, int c, int groups, int chunks, int gps, int vec,
                               float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  unsigned* t = static_cast<unsigned*>(tickets);
  float* m = static_cast<float*>(out);
  float* r = m + (long)b * c;
  cudaError_t err =
      is_bf16 ? gn_stats<bf16>(static_cast<const bf16*>(x), nullptr, m, r, p, t, b, hw, c,
                               groups, chunks, gps, vec, eps, 0, st)
              : gn_stats<float>(static_cast<const float*>(x), nullptr, m, r, p, t, b, hw, c,
                                groups, chunks, gps, vec, eps, 0, st);
  return static_cast<int>(err);
}

// y = GroupNorm(x) (+ SiLU when activate), one launch, no scratch.
// geometry: ops/quant_conv.py::gn_cluster_plan's nine ints {cluster, rows,
// keep, gps, vec, cols, phases, threads, smem} for this shape, checked
// here; vec > 1 needs 16-byte aligned x and y.
extern "C" int ldm_group_norm(const void* x, const void* gamma, const void* beta, void* y, int b,
                              int hw, int c, int groups, float eps, int activate, int is_bf16,
                              const int* geometry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry_of(geometry);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  cudaError_t err =
      is_bf16 ? group_norm<bf16>(x, ga, be, y, b, hw, c, groups, eps, activate, g, st)
              : group_norm<float>(x, ga, be, y, b, hw, c, groups, eps, activate, g, st);
  return static_cast<int>(err);
}

// The most clusters of this geometry the card holds at once, in *out (0:
// the launch cannot run); a cudaError_t value.
extern "C" int ldm_group_norm_clusters(int b, int groups, int is_bf16, const int* geometry,
                                       int* out) {
  const Geometry g = geometry_of(geometry);
  const int slices = groups / g.gps;
  cudaError_t err;
  if (is_bf16)
    err = g.vec > 1 ? gnc::max_clusters(gn_cluster_norm_kernel<bf16, 8>, g, slices, b, out)
                    : gnc::max_clusters(gn_cluster_norm_kernel<bf16, 1>, g, slices, b, out);
  else
    err = g.vec > 1 ? gnc::max_clusters(gn_cluster_norm_kernel<float, 4>, g, slices, b, out)
                    : gnc::max_clusters(gn_cluster_norm_kernel<float, 1>, g, slices, b, out);
  return static_cast<int>(err);
}
