// GroupNorm statistics in one launch, shared by group_norm.cu (the stats
// kernel and the fused GroupNorm) and gn_silu_conv3x3.cu (the chain's first
// stage), so all three move with it.
//
// Layout: x [B, HW, C] (channels last), float32 or bfloat16.
//
// gn_channel_stats_kernel, grid (chunks, slices, B): CTA (chunk, slice, b) reads
// rows [chunk * rows, ...) of image b, the channels of the slice's gps
// groups, in W-element loads along C (16 bytes: 8 bf16 or 4 float32; W = 1
// where C or the base is not 16-byte aligned), and
//  1. sums x and x^2 per channel over its rows in float32, as the TPU
//     kernel does (s1 += sum(x, axis=0)): each thread its rows in order,
//     then the threads' partial sums in a fixed order through shared memory;
//  2. folds the channels into groups, in channel order;
//  3. with one chunk, finishes at once; otherwise writes its group sums to
//     fixed slots of `partial` [B, slices, chunks, gps, 2] and
//     takes a ticket (one counter per (image, slice)): the CTA that draws
//     the last ticket adds the chunks' sums in chunk order, finishes, and
//     sets the counter back to 0 for the next launch;
//  4. finishing: mean = s1 / n, var = s2 / n - mean^2 (clamped at 0 when
//     asked: the chain clamps, the GroupNorm kernels do not, each as its
//     TPU kernel does), rstd = 1 / sqrt(var + eps), with explicit
//     round-to-nearest operations; per channel of the slice it writes mean
//     and rstd, or rstd * gamma when gamma is given (the factor the
//     normalize step multiplies by).
// No float atomics: every sum is taken in an order fixed by the shape (the
// caller picks chunks, groups per slice (gps) and W from the shape, ops/group_norm.py
// stats_grid), so the result is deterministic.  Concurrent launches must
// not share `tickets` (the port launches on one stream).
//
// What bounds it on this card: memory (x is read once, 2 float32
// operations an element), and at the U-Net's small maps the launch itself.
// The grid is sized to fill the card twice: chunks of at least 32 rows up
// to about 264 CTAs, then channel slices where the image has few rows.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace ldm {

constexpr int kStatsThreads = 256;

template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 2) {  // 8 bf16
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < W; ++e) out[e] = to_f32(h[e]);
  } else {  // 4 float32
    const float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
}

// Dynamic shared memory: the threads' partial sums (2 x 256 W floats), then
// the slice's per-channel sums (2 x its channels).
inline size_t gn_stats_smem(int w, int c, int groups, int gps) {
  return (size_t)(2 * kStatsThreads * w + 2 * gps * (c / groups)) * sizeof(float);
}

template <typename T, int W>
__global__ void __launch_bounds__(kStatsThreads)
gn_channel_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                float* __restrict__ mean, float* __restrict__ factor, float* __restrict__ partial,
                unsigned* __restrict__ tickets, int hw, int c, int groups, int gps, float eps,
                int clamp) {
  extern __shared__ float sm[];
  __shared__ float fin[2 * kStatsThreads];  // the finishing CTA's parts
  __shared__ int last;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, slice = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x, slices = gridDim.y;
  const int cg = c / groups;
  const int g0 = slice * gps, ng = min(gps, groups - g0);
  const int c0 = g0 * cg, cw = ng * cg;
  const int rows = (hw + chunks - 1) / chunks;
  const int r0 = min(chunk * rows, hw), r1 = min(r0 + rows, hw);
  float* red1 = sm;
  float* red2 = red1 + kStatsThreads * W;
  float* cs1 = red2 + kStatsThreads * W;
  float* cs2 = cs1 + gps * cg;
  const T* xb = x + (long)b * hw * c + c0;

  // 1. per-channel sums over the chunk's rows, NV vectors of a row at a time
  const int nv = cw / W;
  const int NV = min(nv, kStatsThreads), RP = kStatsThreads / NV;
  const int rp = tid / NV, lv = tid % NV;
  for (int vb = 0; vb < nv; vb += NV) {
    float s1[W], s2[W];
#pragma unroll
    for (int e = 0; e < W; ++e) s1[e] = s2[e] = 0.f;
    const int v = vb + lv;
    if (rp < RP && v < nv) {
#pragma unroll 4
      for (int row = r0 + rp; row < r1; row += RP) {
        float xv[W];
        load_vec<T, W>(xb + (long)row * c + v * W, xv);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          s1[e] += xv[e];
          s2[e] = fmaf(xv[e], xv[e], s2[e]);
        }
      }
    }
    if (rp < RP) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        red1[tid * W + e] = s1[e];
        red2[tid * W + e] = s2[e];
      }
    }
    __syncthreads();
    for (int ch = tid; ch < min(NV, nv - vb) * W; ch += kStatsThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int p = 0; p < RP; ++p) {  // fixed order
        t1 += red1[p * NV * W + ch];
        t2 += red2[p * NV * W + ch];
      }
      cs1[vb * W + ch] = t1;
      cs2[vb * W + ch] = t2;
    }
    __syncthreads();
  }

  // 2. channels into groups, in channel order: gsum [ng][2] (over red1)
  float* gsum = red1;
  for (int g = tid; g < ng; g += kStatsThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < cg; ++i) {
      t1 += cs1[g * cg + i];
      t2 += cs2[g * cg + i];
    }
    gsum[2 * g] = t1;
    gsum[2 * g + 1] = t2;
  }
  __syncthreads();

  // 3. the chunks' sums, added in chunk order by the last CTA to finish
  if (chunks > 1) {
    const long base = (long)(b * slices + slice) * chunks;
    float* mine = partial + (base + chunk) * gps * 2;
    for (int i = tid; i < 2 * ng; i += kStatsThreads) mine[i] = gsum[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&tickets[b * slices + slice], 1u) == (unsigned)(chunks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // parts of consecutive chunks per group, then the parts in order
    const int parts = kStatsThreads / ng;
    const int per = (chunks + parts - 1) / parts;
    if (tid < parts * ng) {
      const int g = tid % ng, part = tid / ng;
      const int k0 = min(part * per, chunks), k1 = min(k0 + per, chunks);
      float t1 = 0.f, t2 = 0.f;
      for (int k = k0; k < k1; ++k) {
        const float* p = partial + ((base + k) * gps + g) * 2;
        t1 += __ldcg(p);
        t2 += __ldcg(p + 1);
      }
      fin[2 * tid] = t1;
      fin[2 * tid + 1] = t2;
    }
    __syncthreads();
    for (int g = tid; g < ng; g += kStatsThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int part = 0; part < parts; ++part) {
        t1 += fin[2 * (part * ng + g)];
        t2 += fin[2 * (part * ng + g) + 1];
      }
      gsum[2 * g] = t1;
      gsum[2 * g + 1] = t2;
    }
    if (tid == 0) tickets[b * slices + slice] = 0u;
    __syncthreads();
  }

  // 4. per channel of the slice
  const float nf = (float)((long)hw * cg);
  for (int ch = tid; ch < cw; ch += kStatsThreads) {
    const int g = ch / cg;
    const float m = __fdiv_rn(gsum[2 * g], nf);
    float var = __fsub_rn(__fdiv_rn(gsum[2 * g + 1], nf), __fmul_rn(m, m));
    if (clamp) var = fmaxf(var, 0.f);
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    const long idx = (long)b * c + c0 + ch;
    mean[idx] = m;
    factor[idx] = gamma != nullptr ? __fmul_rn(rstd, gamma[c0 + ch]) : rstd;
  }
}

template <typename T, int W>
cudaError_t launch_gn_stats(const T* x, const float* gamma, float* mean, float* factor,
                            float* partial, unsigned* tickets, int b, int hw, int c, int groups,
                            int chunks, int gps, float eps, int clamp, cudaStream_t st) {
  const size_t bytes = gn_stats_smem(W, c, groups, gps);
  static size_t smem_set = 48 * 1024;  // raised per instantiation as shapes need it
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_channel_stats_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    smem_set = bytes;
  }
  const int slices = (groups + gps - 1) / gps;
  gn_channel_stats_kernel<T, W><<<dim3(chunks, slices, b), kStatsThreads, bytes, st>>>(
      x, gamma, mean, factor, partial, tickets, hw, c, groups, gps, eps, clamp);
  return cudaGetLastError();
}

// Per-channel mean [B, C] and rstd (or rstd * gamma) [B, C] in one launch.
// chunks, gps (groups per slice), vec: ops/group_norm.py's stats_grid (vec:
// 16 / sizeof(T) for 16-byte loads, else 1); a slice of gps groups is a
// multiple of vec channels.  With slices = ceil(groups / gps), partial:
// B * slices * chunks * gps * 2 floats and tickets: B * slices counters,
// all 0 between launches; neither is touched when chunks == 1.
template <typename T>
cudaError_t gn_stats(const T* x, const float* gamma, float* mean, float* factor,
                     float* partial, unsigned* tickets, int b, int hw, int c, int groups,
                     int chunks, int gps, int vec, float eps, int clamp, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (c % groups != 0 || chunks < 1 || gps < 1 || gps > groups || gps > kStatsThreads ||
      (chunks > 1 && (partial == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  if (vec == kVec) {
    if (c % kVec != 0 || (gps * (c / groups)) % kVec != 0 || !aligned16(x))
      return cudaErrorInvalidValue;
    return launch_gn_stats<T, kVec>(x, gamma, mean, factor, partial, tickets, b, hw, c, groups,
                                    chunks, gps, eps, clamp, st);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return launch_gn_stats<T, 1>(x, gamma, mean, factor, partial, tickets, b, hw, c, groups,
                               chunks, gps, eps, clamp, st);
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
