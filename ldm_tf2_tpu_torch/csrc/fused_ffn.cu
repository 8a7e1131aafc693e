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
// and 3*d*F weights, so it is compute-bound at every main-path shape, and
// the three products have to run on the tensor cores.
//
// Common design (both paths):
//  * one block owns a tile of rows.  It computes the LayerNorm once into
//    shared memory, then loops over the F hidden columns in blocks of 64:
//    the gated hidden block u [rows, 64] goes to shared memory, and u w2 is
//    accumulated in f32 registers.  The [M, F] hidden activation never
//    reaches device memory - what the TPU kernel keeps out of HBM.
//  * when M gives fewer row tiles than the card has SMs (M = 1024, 256, 64
//    on the main path), the F hidden columns are also split into chunks
//    (gridDim.y): each block writes its f32 partial sum to a workspace and a
//    second kernel adds the chunks in a fixed order, with bias and residual.
//    No atomics: results are deterministic.  The workspace holds partial
//    outputs only ([chunks, M, d]); the hidden activation still never
//    leaves the block.
//  * y and u are rounded to the operand type before their products, as the
//    TPU kernel does (its y scratch and u are in the activation dtype).
//
// Tensor-core path (bf16, d = 320, 640 or 1280, F % 64 == 0, 16-byte
// aligned operands): mma.sync m16n8k16 bf16 with f32 accumulation, 8 warps.
// The f32 output accumulator [rows, d] is what bounds the row tile: rows x d
// = 20480 (64 x 320, 32 x 640, 16 x 1280) keeps it at 80 registers a
// thread, and one block fills an SM, so the grid is kept to one wave.  The
// weights stream through a 3-stage cp.async ring in shared memory: row
// slices of w1v and w1g for the first products (each warp owns 8 hidden
// columns), then row slices of w2 for the last (each warp owns a
// [16*MW, 8*NW] tile of the output).  Row strides of width+8 elements keep
// ldmatrix free of bank conflicts.
//
// FMA path (float32, and any other width up to 1280): scalar FMAs.  One
// block owns TM = 16 rows, the LayerNorm output is stored transposed
// ([d][TM], one float4 load gives four rows of one feature), and thread t
// owns output columns t, t+256, ... (80 f32 registers at d = 1280).
// Shared memory is (d + 64) * 16 * 4 bytes: 84 KB at d = 1280.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
    const float bias = to_f32(b2[c]);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const long row = row0 + r;
      if (row < m) out[row * d + c] = from_f32<T>(acc[ci][r] + bias + to_f32(x[row * d + c]));
    }
  }
}

// out = sum over chunks (in order) + b2 + x
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial, const T* __restrict__ b2,
                                  const T* __restrict__ x, T* __restrict__ out, int m, int d,
                                  int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n = (long)m * d;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += partial[k * n + i];
  out[i] = from_f32<T>(s + to_f32(b2[i % d]) + to_f32(x[i]));
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

// ------------------------------------------------------ tensor-core path

constexpr int kStages = 3;   // depth of the cp.async ring
constexpr int kLdH = NB + 8; // row stride of the hidden-width tiles

// Tiles per width: MT m-tiles of 16 rows per block; each warp owns MW
// m-tiles x NW n-tiles of 8 output columns in the last product.  The ring
// carries KA-row slices of w1v and w1g, then KB-row slices of w2; they are
// sized so that one stage holds either and a block fits in shared memory.
template <int D> struct MmaShape;
template <> struct MmaShape<320> { static constexpr int MT = 4, MW = 2, NW = 10, KA = 160, KB = 32; };
template <> struct MmaShape<640> { static constexpr int MT = 2, MW = 2, NW = 10, KA = 128, KB = 32; };
template <> struct MmaShape<1280> { static constexpr int MT = 1, MW = 1, NW = 20, KA = 128, KB = 16; };

// One stage of the ring holds a w1v + w1g slice [2][KA][kLdH] or a w2
// slice [KB][D+8], whichever is larger (in elements).
template <int D>
__host__ __device__ constexpr int stage_elems() {
  return 2 * MmaShape<D>::KA * kLdH > MmaShape<D>::KB * (D + 8) ? 2 * MmaShape<D>::KA * kLdH
                                                                 : MmaShape<D>::KB * (D + 8);
}

// Shared memory: y [TM][D+8], u [TM][kLdH], then the ring.
template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return ((size_t)16 * MmaShape<D>::MT * (D + 8 + kLdH) + (size_t)kStages * stage_elems<D>()) *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ffn_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
               const float* __restrict__ lnb, const bf16* __restrict__ w1v,
               const bf16* __restrict__ b1v, const bf16* __restrict__ w1g,
               const bf16* __restrict__ b1g, const bf16* __restrict__ w2,
               const bf16* __restrict__ b2, bf16* __restrict__ out, float* __restrict__ partial,
               int m, int f, int chunk_cols, float eps) {
  using S = MmaShape<D>;
  constexpr int MT = S::MT, MW = S::MW, NW = S::NW, TMM = 16 * MT, KA = S::KA, KB = S::KB;
  constexpr int LDY = D + 8;
  constexpr int NA = D / KA;          // w1 slices per hidden block
  constexpr int NBK = NB / KB;        // w2 slices per hidden block
  constexpr int ITEMS = NA + NBK;     // ring items per hidden block
  constexpr int WN = (D / 8) / NW;    // warps across the output columns
  constexpr int SE = stage_elems<D>();
  static_assert(D % KA == 0 && KA % 32 == 0 && NB % KB == 0 && KB % 16 == 0 && NW % 2 == 0 &&
                    (MT / MW) * WN == kThreads / 32,
                "tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);
  bf16* us = ys + TMM * LDY;
  bf16* ring = us + TMM * kLdH;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long row0 = (long)blockIdx.x * TMM;
  const int j_begin = blockIdx.y * chunk_cols;
  const int n_items = (min(f, j_begin + chunk_cols) - j_begin) / NB * ITEMS;

  // Ring item i: slice i % ITEMS of hidden block i / ITEMS, into stage i % kStages.
  auto issue = [&](int item) {
    bf16* dst = ring + (item % kStages) * SE;
    const int hb = j_begin + (item / ITEMS) * NB;
    const int sub = item % ITEMS;
    if (sub < NA) {  // w1v and w1g rows [sub*KA, +KA), columns [hb, hb+64)
      for (int i = tid; i < 2 * KA * (NB / 8); i += kThreads) {
        const int which = i / (KA * (NB / 8));
        const int r = (i / (NB / 8)) % KA, c = (i % (NB / 8)) * 8;
        const bf16* src = which ? w1g : w1v;
        cp_async16(dst + (which * KA + r) * kLdH + c, src + (long)(sub * KA + r) * f + hb + c,
                   true);
      }
    } else {  // w2 rows [hb + (sub-NA)*KB, +KB), all D columns
      const int k0 = hb + (sub - NA) * KB;
      for (int i = tid; i < KB * (D / 8); i += kThreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        cp_async16(dst + r * LDY + c, w2 + (long)(k0 + r) * D + c, true);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_items) issue(i);
    cp_async_commit();
  }

  // LayerNorm, one warp per row, rounded to bf16 into ys (zeros past m).
  for (int r = warp; r < TMM; r += kThreads / 32) {
    const long row = row0 + r;
    const bf16* xr = x + row * D;
    float s1 = 0.f, s2 = 0.f;
    if (row < m) {
      for (int c = lane; c < D; c += 32) {
        const float xv = __bfloat162float(xr[c]);
        s1 += xv;
        s2 += xv * xv;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mu = s1 / D;
    const float rstd = rsqrtf(fmaxf(s2 / D - mu * mu, 0.f) + eps);
    for (int c = lane; c < D; c += 32) {
      const float y = row < m ? (__bfloat162float(xr[c]) - mu) * rstd * lns[c] + lnb[c] : 0.f;
      ys[r * LDY + c] = __float2bfloat16(y);
    }
  }

  const int wm = warp / WN, wn = warp % WN;
  float acc[MW][NW][4];
  float av[MT][4], gv[MT][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[mi][e] = gv[mi][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item it has landed; stage (it-1) % kStages is free
    if (it + kStages - 1 < n_items) issue(it + kStages - 1);
    cp_async_commit();
    const bf16* buf = ring + (it % kStages) * SE;
    const int sub = it % ITEMS;
    if (sub < NA) {
      // a, g [TM, 64] += y[:, slice] w1[slice, hb:hb+64]; this warp's 8
      // hidden columns are warp*8 .. warp*8+7.
#pragma unroll
      for (int kp = 0; kp < KA / 32; ++kp) {
        uint32_t bv[4], bg[4];
        ldsm_x4_trans(bv, buf + (kp * 32 + lane) * kLdH + warp * 8);
        ldsm_x4_trans(bg, buf + (KA + kp * 32 + lane) * kLdH + warp * 8);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int kc = sub * KA + kp * 32 + half * 16;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            uint32_t a[4];
            ldsm_x4(a, ys + (mi * 16 + lane % 16) * LDY + kc + (lane / 16) * 8);
            mma_bf16(av[mi], a, bv[2 * half], bv[2 * half + 1]);
            mma_bf16(gv[mi], a, bg[2 * half], bg[2 * half + 1]);
          }
        }
      }
      if (sub == NA - 1) {  // u = (a + b1v) * gelu(g + b1g), rounded, into us
        const int hb = j_begin + (it / ITEMS) * NB;
        const int c = warp * 8 + 2 * t4;
        const float bv0 = __bfloat162float(b1v[hb + c]), bv1 = __bfloat162float(b1v[hb + c + 1]);
        const float bg0 = __bfloat162float(b1g[hb + c]), bg1 = __bfloat162float(b1g[hb + c + 1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float u0 = (av[mi][2 * hr] + bv0) * gelu_exact(gv[mi][2 * hr] + bg0);
            const float u1 = (av[mi][2 * hr + 1] + bv1) * gelu_exact(gv[mi][2 * hr + 1] + bg1);
            *reinterpret_cast<__nv_bfloat162*>(us + (mi * 16 + g + 8 * hr) * kLdH + c) =
                __floats2bfloat162_rn(u0, u1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) av[mi][e] = gv[mi][e] = 0.f;
        }
      }
    } else {
      // acc += u[:, slice] w2[slice, :] on this warp's output tile.
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks) {
        const int kc = (sub - NA) * KB + ks * 16;
        uint32_t a[MW][4];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
          ldsm_x4(a[mi], us + ((wm * MW + mi) * 16 + lane % 16) * kLdH + kc + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NW / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, buf + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDY +
                                wn * NW * 8 + np * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            mma_bf16(acc[mi][2 * np], a[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * np + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }

  float* part = partial == nullptr ? nullptr : partial + (long)blockIdx.y * m * D;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NW; ++ni)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long row = row0 + (wm * MW + mi) * 16 + g + 8 * hr;
        const int c = (wn * NW + ni) * 8 + 2 * t4;
        if (row >= m) continue;
        const float v0 = acc[mi][ni][2 * hr], v1 = acc[mi][ni][2 * hr + 1];
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + row * D + c) = make_float2(v0, v1);
        } else {
          const __nv_bfloat162 xr = *reinterpret_cast<const __nv_bfloat162*>(x + row * D + c);
          *reinterpret_cast<__nv_bfloat162*>(out + row * D + c) = __floats2bfloat162_rn(
              v0 + __bfloat162float(b2[c]) + __bfloat162float(xr.x),
              v1 + __bfloat162float(b2[c + 1]) + __bfloat162float(xr.y));
        }
      }
}

// One block per SM: a block's 256 threads hold about 165 registers each.
constexpr int kMmaTarget = kSMs;

template <int D>
int mma_chunk_columns(int m, int f) {
  return chunk_columns(m, f, 16 * MmaShape<D>::MT, NB, kMmaTarget);
}

template <int D>
cudaError_t launch_mma(const void* x, const float* lns, const float* lnb, const void* w1v,
                       const void* b1v, const void* w1g, const void* b1g, const void* w2,
                       const void* b2, void* out, float* workspace, int m, int f, float eps,
                       cudaStream_t stream) {
  constexpr int TMM = 16 * MmaShape<D>::MT;
  const int cols = mma_chunk_columns<D>(m, f);
  const int chunks = (f + cols - 1) / cols;
  float* partial = chunks > 1 ? workspace : nullptr;
  constexpr size_t bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ffn_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((m + TMM - 1) / TMM, chunks);
  ffn_mma_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), lns, lnb, static_cast<const bf16*>(w1v),
      static_cast<const bf16*>(b1v), static_cast<const bf16*>(w1g),
      static_cast<const bf16*>(b1g), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), partial, m, f, cols, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  return launch_reduce<bf16>(partial, b2, x, out, m, D, chunks, stream);
}

// The tensor-core path's shapes: d of the U-Net's three levels, F in whole
// 64-column blocks, and 16-byte aligned operands for cp.async.
bool takes_mma(const void* x, const void* w1v, const void* w1g, const void* w2,
               const void* out, int d, int f) {
  return (d == 320 || d == 640 || d == 1280) && f % NB == 0 && aligned16(x) &&
         aligned16(w1v) && aligned16(w1g) && aligned16(w2) && aligned16(out);
}

long long workspace_floats(int cols, int m, int d, int f) {
  const int chunks = (f + cols - 1) / cols;
  return chunks > 1 ? (long long)chunks * m * d : 0;
}

}  // namespace

// Floats of f32 workspace ldm_fused_ffn_fwd needs for these sizes (0 when
// F is not split): enough for whichever path the call takes.
extern "C" long long ldm_fused_ffn_workspace_floats(int m, int d, int f) {
  const int mma_cols = d == 320    ? mma_chunk_columns<320>(m, f)
                       : d == 640  ? mma_chunk_columns<640>(m, f)
                       : d == 1280 ? mma_chunk_columns<1280>(m, f)
                                   : 0;
  const long long fma = workspace_floats(chunk_columns(m, f, TM, NB, kFmaTarget), m, d, f);
  const long long mma = mma_cols > 0 ? workspace_floats(mma_cols, m, d, f) : 0;
  return fma > mma ? fma : mma;
}

// Returns a cudaError_t value (0 on success).  lns/lnb are float32; every
// other operand has the activation type (is_bf16: 1 bfloat16, 0 float32).
// workspace: ldm_fused_ffn_workspace_floats(m, d, f) floats, or null when
// that is 0.  The caller checks shapes (1 <= d <= 1280).
extern "C" int ldm_fused_ffn_fwd(const void* x, const void* lns, const void* lnb,
                                 const void* w1v, const void* b1v, const void* w1g,
                                 const void* b1g, const void* w2, const void* b2, void* out,
                                 void* workspace, int m, int d, int f, float eps, int is_bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(lns);
  const float* b = static_cast<const float*>(lnb);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err;
  if (!is_bf16) {
    err = dispatch_fma<float>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, st);
  } else if (takes_mma(x, w1v, w1g, w2, out, d, f)) {
    switch (d) {
      case 320: err = launch_mma<320>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, f, eps, st); break;
      case 640: err = launch_mma<640>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, f, eps, st); break;
      default: err = launch_mma<1280>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, f, eps, st); break;
    }
  } else {
    err = dispatch_fma<bf16>(x, s, b, w1v, b1v, w1g, b1g, w2, b2, out, ws, m, d, f, eps, st);
  }
  return static_cast<int>(err);
}
