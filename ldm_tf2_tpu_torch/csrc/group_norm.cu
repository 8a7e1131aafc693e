// GroupNorm for Hopper (sm_90a): the statistics alone, and the whole
// GroupNorm (+ SiLU).
//
// Replaces two TPU kernels of ldm_tf2_tpu/ops/group_norm.py:
//  * _gn_stats_kernel (through _pallas_group_stats): per-channel mean and
//    rstd = rsqrt(E[x^2] - mean^2 + eps) over HW blocks; the normalize
//    stays outside (ldm_group_stats, one launch: gn_stats.cuh);
//  * _gn_kernel (through _pallas_group_norm): stats, normalize, affine
//    (x - mean) * (rstd * gamma) + beta, optional SiLU, result in x's type
//    (ldm_group_norm, two launches: the stats, then one elementwise pass).
// Neither clamps the variance, as neither TPU kernel does.
//
// Layout: x, y [B, HW, C] (channels last), float32 or bfloat16; gamma, beta
// [C] float32; mean, rstd [B, C] float32.
//
// What bounds it on this card: memory.  The fused GroupNorm reads x twice
// (stats, normalize) and writes y once, about 12 float32 operations an
// element; the TPU kernel read x once from a VMEM slab that held a whole
// image, which at the autoencoder's 256^2 maps (65,536 positions) no slab
// does.  Streaming HW twice keeps every size on one code path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gn_stats.cuh"

namespace {

using namespace ldm;

template <typename T>
cudaError_t group_norm(const void* x, const float* gamma, const float* beta, void* y,
                       float* stats, float* partial, unsigned* tickets, int b, int hw, int c,
                       int groups, int chunks, int gps, int vec, float eps, int activate,
                       cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  float* mean = stats;
  float* factor = mean + (long)b * c;
  cudaError_t err = gn_stats<T>(xt, gamma, mean, factor, partial, tickets, b, hw, c, groups,
                                chunks, gps, vec, eps, /*clamp=*/0, st);
  if (err != cudaSuccess) return err;
  return gn_normalize<T>(xt, mean, factor, beta, static_cast<T*>(y), b, hw, c, activate, st);
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

// y = GroupNorm(x) (+ SiLU when activate).  stats: 2 * B * C floats of
// scratch (mean, rstd * gamma); partial, tickets, chunks, gps, vec as
// for ldm_group_stats.
extern "C" int ldm_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                              void* stats, void* partial, void* tickets, int b, int hw, int c,
                              int groups, int chunks, int gps, int vec, float eps,
                              int activate, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* s = static_cast<float*>(stats);
  float* p = static_cast<float*>(partial);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaError_t err =
      is_bf16 ? group_norm<bf16>(x, g, be, y, s, p, t, b, hw, c, groups, chunks, gps, vec,
                                 eps, activate, st)
              : group_norm<float>(x, g, be, y, s, p, t, b, hw, c, groups, chunks, gps, vec,
                                  eps, activate, st);
  return static_cast<int>(err);
}
