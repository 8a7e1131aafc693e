// Fused transformer FFN for Hopper (sm_90a):
//   y = LayerNorm(x) (f32 statistics, fast variance E[x^2]-E[x]^2 >= 0)
//   u = (y w1v + b1v) * gelu(y w1g + b1g)      (exact erf GELU)
//   out = u w2 + b2 + x
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/fused_ffn.py::_ffn_kernel (reached
// there through _pallas_ffn / fused_ffn).  Weights keep the JAX layouts:
// w1v, w1g [d, F] (in x out), w2 [F, d]; x and out are [M, d] row-major.
//
// What bounds it on this card: 6*M*d*F operations against M*d activations
// and 3*d*F weights: compute-bound at d = 320 and 640 on the main path, and
// bound by the 39 MB of weights at d = 1280 (M = 64 to 512).  The products
// have to run on the tensor cores.
//
// Rounding (the TPU kernel's): y and u are rounded to the operand type
// before their products (its y scratch and u are in the activation dtype);
// a and g take their biases in f32; the output is the product rounded to T,
// then + b2, then + x, each add rounded to T (ffn_out).
//
// wgmma path (bf16, d a multiple of 128 or 160 up to 1280, F a multiple of
// 128, 16-byte aligned operands: every FFN of the models), three launches
// (four when the last splits), geometry from the wrapper's ffn_plan:
//  1. ffn_ln_kernel: y = LN(x) in bf16, one warp per row, written once (the
//     TPU kernel's ln_ref scratch; a CTA of the up-projection reads only its
//     rows' 64-feature slices, and several CTAs read each row);
//  2. ffn_up_kernel: u = (y w1v + b1v) * gelu(y w1g + b1g) in bf16 [M, F].
//     A CTA owns a row tile (64 rows, or 128 where M > 64) and a range of
//     hidden blocks of 64 columns; a producer warp streams TMA tiles into an
//     mbarrier ring: y's 64-feature slices (K-major A) and the block's w1v
//     and w1g slices as stored ([d, F], MN-major B chunks side by side), so
//     one SS wgmma m64n128k16 per 64 rows computes a and g together; the
//     GEGLU with the exact erf runs on the accumulator registers.  With a
//     128-row tile, two consumer warpgroups take alternate blocks (each all
//     128 rows) and turns at the tensor cores, so that one's GEGLU runs
//     while the other's products do;
//  3. ffn_down_kernel: out = u w2 + b2 + x, an SS wgmma GEMM (u K-major by
//     TMA, w2 [F, d] MN-major as stored) over N tiles of 128 or 160 columns;
//     where the tiles cannot fill the card the F / 64 k-steps split over
//     blockIdx.z into float32 slots, and ffn_reduce4_kernel adds them in
//     split order and applies the epilogue: deterministic.
// u [M, F] makes one round trip through device memory (at most 10.5 MB on
// the main path, L2-resident).  Feeding u from registers into the second
// product instead keeps the f32 output accumulator beside [a | g]: 160 + 64
// registers a thread at d = 320, more than ptxas gave two consumer
// warpgroups (it spilled, and was slower than these launches; PERF.md).
//
// FMA path (float32, whose products the TPU computes exactly, and bf16
// widths the wgmma plan declines, up to 1280): scalar FMAs.  One block owns
// TM = 16 rows, the LayerNorm output is stored transposed ([d][TM], one
// float4 load gives four rows of one feature), and thread t owns output
// columns t, t+256, ... (80 f32 registers at d = 1280).  Shared memory is
// (d + 64) * 16 * 4 bytes: 84 KB at d = 1280.  When M gives fewer row tiles
// than there are SMs, the F hidden columns are also split into chunks
// (gridDim.y): each block writes its f32 partial sum to a workspace and
// ffn_reduce_kernel adds the chunks in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 256;
constexpr int TM = 16;
constexpr int NB = 64;
constexpr int kRowsA = TM / (kThreads / NB);  // rows per thread in phase A
static_assert(kRowsA == 4, "phase A loads one float4 of rows");

// Round an f32 value to the operand type and back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float gelu_exact(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// The JAX kernel's epilogue: the product rounded to T, then + b2, then + x,
// each add rounded to T.
template <typename T>
__device__ __forceinline__ T ffn_out(float acc, T b2, T x) {
  const float v = round_to<T>(round_to<T>(acc) + to_f32(b2));
  return from_f32<T>(v + to_f32(x));
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
ffn_kernel(const T* __restrict__ x, const float* __restrict__ lns, const float* __restrict__ lnb,
           const T* __restrict__ w1v, const T* __restrict__ b1v, const T* __restrict__ w1g,
           const T* __restrict__ b1g, const T* __restrict__ w2, const T* __restrict__ b2,
           T* __restrict__ out, float* __restrict__ partial, int m, int d, int f,
           int chunk_cols, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* yt = smem;         // [d][TM]
  float* ut = yt + d * TM;  // [NB][TM]
  __shared__ float mean_s[TM], rstd_s[TM];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long row0 = (long)blockIdx.x * TM;

  // LayerNorm statistics, one warp per row.
  for (int r = warp; r < TM; r += kThreads / 32) {
    const long row = row0 + r;
    float s1 = 0.f, s2 = 0.f;
    if (row < m) {
      for (int c = lane; c < d; c += 32) {
        const float xv = to_f32(x[row * d + c]);
        s1 += xv;
        s2 += xv * xv;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mu = s1 / d;
      mean_s[r] = mu;
      rstd_s[r] = rsqrtf(fmaxf(s2 / d - mu * mu, 0.f) + eps);
    }
  }
  __syncthreads();
  for (int i = tid; i < TM * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const long row = row0 + r;
    float y = 0.f;
    if (row < m) {
      const float xv = to_f32(x[row * d + c]);
      y = round_to<T>((xv - mean_s[r]) * rstd_s[r] * lns[c] + lnb[c]);
    }
    yt[c * TM + r] = y;
  }

  float acc[NC][TM];
#pragma unroll
  for (int ci = 0; ci < NC; ++ci)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[ci][r] = 0.f;

  const int hc = tid % NB;             // phase A: hidden column in the block
  const int ra = (tid / NB) * kRowsA;  // phase A: first of its four rows

  const int j_begin = blockIdx.y * chunk_cols;
  const int j_end = min(f, j_begin + chunk_cols);
  for (int j0 = j_begin; j0 < j_end; j0 += NB) {
    __syncthreads();  // yt complete / previous phase B done with ut
    const int col = j0 + hc < j_end ? j0 + hc : f;
    float av[kRowsA] = {0.f, 0.f, 0.f, 0.f}, gv[kRowsA] = {0.f, 0.f, 0.f, 0.f};
    if (col < f) {
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        const float4 y4 = *reinterpret_cast<const float4*>(yt + c * TM + ra);
        const float wv = to_f32(w1v[(long)c * f + col]);
        const float wg = to_f32(w1g[(long)c * f + col]);
        av[0] = fmaf(y4.x, wv, av[0]);
        av[1] = fmaf(y4.y, wv, av[1]);
        av[2] = fmaf(y4.z, wv, av[2]);
        av[3] = fmaf(y4.w, wv, av[3]);
        gv[0] = fmaf(y4.x, wg, gv[0]);
        gv[1] = fmaf(y4.y, wg, gv[1]);
        gv[2] = fmaf(y4.z, wg, gv[2]);
        gv[3] = fmaf(y4.w, wg, gv[3]);
      }
      const float bv = to_f32(b1v[col]), bg = to_f32(b1g[col]);
#pragma unroll
      for (int i = 0; i < kRowsA; ++i)
        ut[hc * TM + ra + i] = round_to<T>((av[i] + bv) * gelu_exact(gv[i] + bg));
    } else {
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) ut[hc * TM + ra + i] = 0.f;
    }
    __syncthreads();

    const int nb = min(NB, j_end - j0);
    for (int n = 0; n < nb; ++n) {
      float u[TM];
#pragma unroll
      for (int r4 = 0; r4 < TM; r4 += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(ut + n * TM + r4);
        u[r4] = v4.x;
        u[r4 + 1] = v4.y;
        u[r4 + 2] = v4.z;
        u[r4 + 3] = v4.w;
      }
      const T* w2row = w2 + (long)(j0 + n) * d;
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) {
        const int c = tid + ci * kThreads;
        if (c < d) {
          const float w = to_f32(w2row[c]);
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[ci][r] = fmaf(u[r], w, acc[ci][r]);
        }
      }
    }
  }

  if (partial != nullptr) {  // split over F: the reduce kernel finishes
    float* part = partial + (long)blockIdx.y * m * d;
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      const int c = tid + ci * kThreads;
      if (c >= d) continue;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const long row = row0 + r;
        if (row < m) part[row * d + c] = acc[ci][r];
      }
    }
    return;
  }
#pragma unroll
  for (int ci = 0; ci < NC; ++ci) {
    const int c = tid + ci * kThreads;
    if (c >= d) continue;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const long row = row0 + r;
      if (row < m) out[row * d + c] = ffn_out<T>(acc[ci][r], b2[c], x[row * d + c]);
    }
  }
}

// out = ffn_out(sum over chunks, in order)
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial, const T* __restrict__ b2,
                                  const T* __restrict__ x, T* __restrict__ out, int m, int d,
                                  int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n = (long)m * d;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += partial[k * n + i];
  out[i] = ffn_out<T>(s, b2[i % d], x[i]);
}

constexpr int kSMs = 132;

// Columns of F per chunk (a multiple of nb): F is split over gridDim.y only
// when M gives fewer row tiles than there are SMs, into at most `target`
// blocks in all (the blocks that fit on the card at once).
int chunk_columns(int m, int f, int tm, int nb, int target) {
  const int row_tiles = (m + tm - 1) / tm;
  const int col_blocks = (f + nb - 1) / nb;
  if (row_tiles >= kSMs) return col_blocks * nb;
  const int chunks = min(col_blocks, max(1, target / row_tiles));
  return (col_blocks + chunks - 1) / chunks * nb;
}

template <typename T>
cudaError_t launch_reduce(const float* partial, const void* b2, const void* x, void* out, int m,
                          int d, int chunks, cudaStream_t stream) {
  const long n = (long)m * d;
  ffn_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<const T*>(b2), static_cast<const T*>(x), static_cast<T*>(out), m, d,
      chunks);
  return cudaGetLastError();
}

// FMA path: about two blocks per SM.
constexpr int kFmaTarget = 2 * kSMs;

template <typename T, int NC>
cudaError_t launch(const void* x, const float* lns, const float* lnb, const void* w1v,
                   const void* b1v, const void* w1g, const void* b1g, const void* w2,
                   const void* b2, void* out, float* workspace, int m, int d, int f,
                   float eps, cudaStream_t stream) {
  const int cols = chunk_columns(m, f, TM, NB, kFmaTarget);
  const int chunks = (f + cols - 1) / cols;
  float* partial = chunks > 1 ? workspace : nullptr;
  const size_t bytes = (size_t)(d + NB) * TM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((m + TM - 1) / TM, chunks);
  ffn_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), lns, lnb, static_cast<const T*>(w1v), static_cast<const T*>(b1v),
      static_cast<const T*>(w1g), static_cast<const T*>(b1g), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), partial, m, d, f, cols, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  return launch_reduce<T>(partial, b2, x, out, m, d, chunks, stream);
}

template <typename T>
cudaError_t dispatch_fma(const void* x, const float* lns, const float* lnb, const void* w1v,
                         const void* b1v, const void* w1g, const void* b1g, const void* w2,
                         const void* b2, void* out, float* ws, int m, int d, int f, float eps,
                         cudaStream_t stream) {
  switch ((d + kThreads - 1) / kThreads) {
    case 1: return launch<T, 1>(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, stream);
    case 2: return launch<T, 2>(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, stream);
    case 3: return launch<T, 3>(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, stream);
    case 4: return launch<T, 4>(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, stream);
    case 5: return launch<T, 5>(x, lns, lnb, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

long long workspace_floats(int cols, int m, int d, int f) {
  const int chunks = (f + cols - 1) / cols;
  return chunks > 1 ? (long long)chunks * m * d : 0;
}

// ------------------------------------------------------------ wgmma path

// Launch 1: y = LayerNorm(x) in bf16, one warp per row (the TPU kernel's
// ln_ref scratch, computed once per row and read by every CTA of the row).
// A lane holds its at most kLnVecs 16-byte pieces of the row in registers
// between the statistics and the normalization (d <= 32 * 8 * kLnVecs).
constexpr int kLnVecs = 5;

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__global__ void __launch_bounds__(256)
ffn_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
              const float* __restrict__ lnb, bf16* __restrict__ y, int m, int d, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * 8 + warp;
  if (row >= m) return;
  const int nv = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 v[kLnVecs];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kLnVecs; ++i) {
    if (lane + 32 * i >= nv) break;
    v[i] = xr[lane + 32 * i];
    float f[8];
    unpack8(v[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s1 += f[e];
      s2 += f[e] * f[e];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 / d;
  const float rstd = rsqrtf(fmaxf(s2 / d - mu * mu, 0.f) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kLnVecs; ++i) {
    const int c = lane + 32 * i;
    if (c >= nv) break;
    float f[8];
    unpack8(v[i], f);
    const float4* sc = reinterpret_cast<const float4*>(lns + 8 * c);
    const float4* bi = reinterpret_cast<const float4*>(lnb + 8 * c);
    const float4 s0 = sc[0], s4 = sc[1], b0 = bi[0], b4 = bi[1];
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s4.x, s4.y, s4.z, s4.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b4.x, b4.y, b4.z, b4.w};
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p =
          __floats2bfloat162_rn((f[2 * e] - mu) * rstd * sv[2 * e] + bv[2 * e],
                                (f[2 * e + 1] - mu) * rstd * sv[2 * e + 1] + bv[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    yr[c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Launch 2, the up-projection: a row tile of BM = 64 NWG rows; a stage is
// one A tile (BM rows x 64 features of y, K-major) and one B tile (64
// features x 64 hidden columns of w1v, then the same of w1g: two MN-major
// chunks, so one m64n128k16 per 64-row sub-tile computes a and g side by
// side).
template <int NWG, int STAGES>
struct FfnUp {
  static constexpr int BM = 64 * NWG;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = 2 * 64 * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;  // + one producer warp
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(SMEM <= 232448, "shared memory");
};

// Grid (row tiles, hidden groups): CTA (i, j) writes u = (y w1v + b1v) *
// gelu(y w1g + b1g), rounded to bf16, for rows [BM i, BM i + BM) and the
// 64-column hidden blocks [per j, min(per (j + 1), f / 64)).  Each consumer
// warpgroup computes all BM rows (NWG sub-tiles of 64) of every NWG-th
// block, and two warpgroups take turns at the tensor cores: one issues its
// block's products while the other runs the GEGLU of its last block on the
// FMA pipe (named barriers 1 and 2 pass the turn).
template <int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
ffn_up_kernel(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap gmap, const bf16* __restrict__ b1v,
              const bf16* __restrict__ b1g, bf16* __restrict__ u, int m, int d, int f, int per) {
  using C = FfnUp<NWG, STAGES>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * C::BM;
  const int kd = d / 64;  // k-steps per hidden block
  const int hb0 = blockIdx.y * per;
  const int nb = min(per, f / 64 - hb0);  // this CTA's hidden blocks
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);  // one warpgroup consumes each stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      for (int it = 0; it < nb * kd; ++it) {
        const int st = it % STAGES, hb = hb0 + it / kd, kc = it % kd;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        unsigned char* a = ring + st * C::STAGE_BYTES;
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        tma_load_4d(a, &ymap, &full[st], kc * 64, row0, 0, 0);
        tma_load_4d(a + C::A_BYTES, &vmap, &full[st], hb * 64, kc * 64, 0, 0);
        tma_load_4d(a + C::A_BYTES + 64 * 128, &gmap, &full[st], hb * 64, kc * 64, 0, 0);
      }
    }
    return;
  }

  // consumers: register 4j + e of sub-tile mt holds row 64 mt + 16 (warp %
  // 4) + g + 8 (e / 2), column 8j + 2 t4 + (e % 2) of [a | g]: a's column c
  // in j = c / 8, g's in j = 8 + c / 8.
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  if (NWG > 1 && wg == 1) named_arrive(1, 256);  // warpgroup 0 takes the first turn
  float acc[NWG][64];
  for (int bl = wg; bl < nb; bl += NWG) {
    if (NWG > 1) named_sync(1 + wg, 256);  // this warpgroup's turn
    for (int kc = 0; kc < kd; ++kc) {
      const int it = bl * kd + kc, st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t a = smem_u32(ring + st * C::STAGE_BYTES);
      const uint32_t bt = a + C::A_BYTES;
#pragma unroll
      for (int mt = 0; mt < NWG; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mt = 0; mt < NWG; ++mt)
          WgmmaSSMN<128>::run(acc[mt], desc_kmajor(a, C::BM, mt * 64, kk),
                              desc_mnmajor(bt, 64, 0, kk), kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // item it - 1's products are done: refill its slot
#pragma unroll
      for (int mt = 0; mt < NWG; ++mt) fence_regs(acc[mt]);
      if (kc > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    if (NWG > 1 && bl + 1 < nb) named_arrive(2 - wg, 256);  // the other's turn
    wgmma_wait<0>();  // the hidden block's sums are complete
#pragma unroll
    for (int mt = 0; mt < NWG; ++mt) fence_regs(acc[mt]);
    mbar_arrive(&empty[(bl * kd + kd - 1) % STAGES]);
    const int col0 = (hb0 + bl) * 64 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < NWG; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = row0 + mt * 64 + (warp % 4) * 16 + g + 8 * half;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + 8 * j;
          const float a0 = acc[mt][4 * j + 2 * half] + __bfloat162float(b1v[col]);
          const float a1 = acc[mt][4 * j + 2 * half + 1] + __bfloat162float(b1v[col + 1]);
          const float g0 = acc[mt][32 + 4 * j + 2 * half] + __bfloat162float(b1g[col]);
          const float g1 = acc[mt][32 + 4 * j + 2 * half + 1] + __bfloat162float(b1g[col + 1]);
          *reinterpret_cast<__nv_bfloat162*>(u + row * f + col) =
              __floats2bfloat162_rn(a0 * gelu_exact(g0), a1 * gelu_exact(g1));
        }
      }
    }
  }
}

// Launch 3, the down-projection: out = u w2 + b2 + x.  A stage is one A
// tile (BM rows x 64 hidden columns of u, K-major) and one B tile (64
// hidden rows x BN output columns of w2, MN-major chunks of 64 columns).
template <int NWG, int BN, int STAGES>
struct FfnDown {
  static constexpr int BM = 64 * NWG;
  static constexpr int CHUNKS = (BN + 63) / 64;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = CHUNKS * 64 * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(SMEM <= 232448, "shared memory");
};

// Grid (row tiles, d / BN, splits): split z reduces hidden k-steps of 64
// [z * per_split, min((z + 1) * per_split, f / 64)).  partial: null when
// there is one split (the epilogue runs here), else [splits, m, d] float32,
// which ffn_reduce4_kernel adds in split order.
template <int NWG, int BN, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
ffn_down_kernel(const __grid_constant__ CUtensorMap umap,
                const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ b2,
                const bf16* __restrict__ x, bf16* __restrict__ out, float* __restrict__ partial,
                int m, int d, int f, int per_split) {
  using C = FfnDown<NWG, BN, STAGES>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * per_split;
  const int nk = min(per_split, f / 64 - k0);
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    if (lane == 0) {
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES, kc = k0 + j;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        unsigned char* a = ring + st * C::STAGE_BYTES;
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        tma_load_4d(a, &umap, &full[st], kc * 64, row0, 0, 0);
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load_4d(a + C::A_BYTES + c * 64 * 128, &w2map, &full[st], n0 + 64 * c, kc * 64, 0,
                      0);
      }
    }
    return;
  }

  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t a = smem_u32(ring + st * C::STAGE_BYTES);
    const uint32_t bt = a + C::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSSMN<BN>::run(acc, desc_kmajor(a, C::BM, wg * 64, kk), desc_mnmajor(bt, 64, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (j > 0) mbar_arrive(&empty[(j - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long row = row0 + wg * 64 + (warp % 4) * 16 + g + 8 * half;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (col >= d) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(partial + ((long)blockIdx.z * m + row) * d + col) =
            make_float2(v0, v1);
      } else {
        const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + row * d + col);
        __nv_bfloat162 o;
        o.x = ffn_out<bf16>(v0, b2[col], xr.x);
        o.y = ffn_out<bf16>(v1, b2[col + 1], xr.y);
        *reinterpret_cast<__nv_bfloat162*>(out + row * d + col) = o;
      }
    }
  }
}

// The last launch of a split down-projection: out = ffn_out(sum of the
// splits' partials, in split order), four columns a thread (d % 4 == 0).
__global__ void __launch_bounds__(256)
ffn_reduce4_kernel(const float* __restrict__ partial, const bf16* __restrict__ b2,
                   const bf16* __restrict__ x, bf16* __restrict__ out, int m, int d, int splits) {
  const long n4 = (long)m * d / 4;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float4 p = reinterpret_cast<const float4*>(partial)[z * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const int c = (int)(4 * i % d);
    const uint2 xv = reinterpret_cast<const uint2*>(x)[i];
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    __nv_bfloat162 lo, hi;
    lo.x = ffn_out<bf16>(s.x, b2[c], xs[0]);
    lo.y = ffn_out<bf16>(s.y, b2[c + 1], xs[1]);
    hi.x = ffn_out<bf16>(s.z, b2[c + 2], xs[2]);
    hi.y = ffn_out<bf16>(s.w, b2[c + 3], xs[3]);
    uint2 o;
    o.x = *reinterpret_cast<const uint32_t*>(&lo);
    o.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(out)[i] = o;
  }
}

// geometry: {up warpgroups, up stages, hidden blocks per up CTA, down
// warpgroups, down N tile, down stages, down k-steps per split, up shared
// bytes, down shared bytes}, from ops/fused_ffn.py's ffn_plan; a geometry
// this build does not hold is refused.
template <int NWG, int STAGES>
cudaError_t launch_up(const int* geo, const CUtensorMap& ym, const CUtensorMap& vm,
                      const CUtensorMap& gm, const bf16* b1v, const bf16* b1g, bf16* u, int m,
                      int d, int f, cudaStream_t st) {
  using C = FfnUp<NWG, STAGES>;
  auto kernel = ffn_up_kernel<NWG, STAGES>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int per = geo[2], blocks = f / 64;
  const dim3 grid((m + C::BM - 1) / C::BM, (blocks + per - 1) / per);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(ym, vm, gm, b1v, b1g, u, m, d, f, per);
  return cudaGetLastError();
}

template <int NWG, int BN, int STAGES>
cudaError_t launch_down(const int* geo, const CUtensorMap& um, const CUtensorMap& wm,
                        const bf16* b2, const bf16* x, bf16* out, float* partial, int m,
                        int d, int f, cudaStream_t st) {
  using C = FfnDown<NWG, BN, STAGES>;
  auto kernel = ffn_down_kernel<NWG, BN, STAGES>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int per_split = geo[6];
  const int splits = (f / 64 + per_split - 1) / per_split;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((m + C::BM - 1) / C::BM, (d + BN - 1) / BN, splits);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(um, wm, b2, x, out, splits > 1 ? partial : nullptr, m,
                                           d, f, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long n4 = (long)m * d / 4;
  const long nblk = (n4 + 255) / 256;
  ffn_reduce4_kernel<<<(unsigned)(nblk < 132 * 8 ? nblk : 132 * 8), 256, 0, st>>>(
      partial, b2, x, out, m, d, splits);
  return cudaGetLastError();
}

// The instantiations: ops/fused_ffn.py's FFN_UP_STAGES and FFN_DOWN_STAGES.
cudaError_t run_wgmma(const bf16* x, const float* lns, const float* lnb, const bf16* w1v,
                      const bf16* b1v, const bf16* w1g, const bf16* b1g, const bf16* w2,
                      const bf16* b2, bf16* out, bf16* y, bf16* u, float* partial, int m,
                      int d, int f, float eps, const int* geo, cudaStream_t st) {
  CUtensorMap ym, vm, gm, um, wm;
  const int up_bm = 64 * geo[0], down_bm = 64 * geo[3];
  cudaError_t err = hopper::make_bf16_map(&ym, y, {d, m, 1, 1}, {64, up_bm, 1, 1});
  if (err == cudaSuccess) err = hopper::make_bf16_map(&vm, w1v, {f, d, 1, 1}, {64, 64, 1, 1});
  if (err == cudaSuccess) err = hopper::make_bf16_map(&gm, w1g, {f, d, 1, 1}, {64, 64, 1, 1});
  if (err == cudaSuccess) err = hopper::make_bf16_map(&um, u, {f, m, 1, 1}, {64, down_bm, 1, 1});
  if (err == cudaSuccess) err = hopper::make_bf16_map(&wm, w2, {d, f, 1, 1}, {64, 64, 1, 1});
  if (err != cudaSuccess) return err;
#define LDM_UP(NWG, STAGES) \
  (geo[0] == NWG && geo[1] == STAGES && geo[7] == FfnUp<NWG, STAGES>::SMEM)
  const int up = LDM_UP(1, 8) ? 1 : LDM_UP(2, 7) ? 2 : 0;
#undef LDM_UP
#define LDM_DOWN(NWG, BN, STAGES) \
  (geo[3] == NWG && geo[4] == BN && geo[5] == STAGES && geo[8] == FfnDown<NWG, BN, STAGES>::SMEM)
  const int down = LDM_DOWN(1, 128, 8) ? 1 : LDM_DOWN(2, 128, 7) ? 2 : LDM_DOWN(1, 160, 7) ? 3
                   : LDM_DOWN(2, 160, 5) ? 4 : 0;
#undef LDM_DOWN
  if (up == 0 || down == 0 || geo[2] < 1 || geo[6] < 1) return cudaErrorInvalidValue;
  if (d > 32 * 8 * kLnVecs) return cudaErrorInvalidValue;
  ffn_ln_kernel<<<(m + 7) / 8, 256, 0, st>>>(x, lns, lnb, y, m, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = up == 1 ? launch_up<1, 8>(geo, ym, vm, gm, b1v, b1g, u, m, d, f, st)
                : launch_up<2, 7>(geo, ym, vm, gm, b1v, b1g, u, m, d, f, st);
  if (err != cudaSuccess) return err;
  switch (down) {
    case 1: return launch_down<1, 128, 8>(geo, um, wm, b2, x, out, partial, m, d, f, st);
    case 2: return launch_down<2, 128, 7>(geo, um, wm, b2, x, out, partial, m, d, f, st);
    case 3: return launch_down<1, 160, 7>(geo, um, wm, b2, x, out, partial, m, d, f, st);
    default: return launch_down<2, 160, 5>(geo, um, wm, b2, x, out, partial, m, d, f, st);
  }
}

}  // namespace

// Floats of f32 workspace the FMA path needs for these sizes (0 when F is
// not split).
extern "C" long long ldm_fused_ffn_workspace_floats(int m, int d, int f) {
  return workspace_floats(chunk_columns(m, f, TM, NB, kFmaTarget), m, d, f);
}

// Returns a cudaError_t value (0 on success).  lns/lnb are float32; every
// other operand has the activation type (is_bf16: 1 bfloat16, 0 float32).
// geometry: null, or the wgmma path's plan (bf16; the caller's ffn_plan),
// which then runs or fails; it also needs y [m, d] and u [m, f] bf16 scratch
// and, when the plan splits the down-projection, `workspace` [splits, m, d]
// floats.
// Without a plan (the FMA path), workspace: ldm_fused_ffn_workspace_floats(m,
// d, f) floats, or null when that is 0.  *path receives the path taken: 0
// FMA, 2 wgmma.  The caller checks shapes (1 <= d <= 1280).
extern "C" int ldm_fused_ffn_fwd(const void* x, const void* lns, const void* lnb,
                                 const void* w1v, const void* b1v, const void* w1g,
                                 const void* b1g, const void* w2, const void* b2, void* out,
                                 void* workspace, void* y, void* u, int m, int d, int f,
                                 float eps, int is_bf16, const int* geometry, int* path,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(lns);
  const float* b = static_cast<const float*>(lnb);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err;
  if (geometry != nullptr) {  // the caller's plan: wgmma, or an error
    *path = 2;
    if (!is_bf16 || d % 64 != 0 || f % 128 != 0 || !aligned16(x) || !aligned16(lns) ||
        !aligned16(lnb) || !aligned16(w1v) || !aligned16(w1g) || !aligned16(w2) ||
        !aligned16(out) || !aligned16(y) || !aligned16(u))
      return static_cast<int>(cudaErrorInvalidValue);
    err = run_wgmma(static_cast<const bf16*>(x), s, b, static_cast<const bf16*>(w1v),
                    static_cast<const bf16*>(b1v), static_cast<const bf16*>(w1g),
                    static_cast<const bf16*>(b1g), static_cast<const bf16*>(w2),
                    static_cast<const bf16*>(b2), static_cast<bf16*>(out), static_cast<bf16*>(y),
                    static_cast<bf16*>(u), ws, m, d, f, eps, geometry, st);
  } else {
    *path = 0;
    err = is_bf16 ? dispatch_fma<bf16>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f,
                                       eps, st)
                  : dispatch_fma<float>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f,
                                        eps, st);
  }
  return static_cast<int>(err);
}
