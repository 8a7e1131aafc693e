// W8A8 transformer FFN for Hopper (sm_90a):
//   y   = LayerNorm(x)                       f32 statistics, fast variance clamped at 0
//   sy  = max(max_j |y|, 1e-8) * (1/127)     per row;  y8 = clip(rint(y * (1/sy)), +-127)
//   a   = f32(i32(y8 . w1v8)) * (sy * s1v) + b1v,   g likewise with w1g8, s1g, b1g
//   u   = a * gelu_poly(g)                   f32, the JAX package's polynomial GELU
//   su  = max(max_j |u|, 1e-8) * (1/127)     per row, over the whole hidden row F = 4d
//   u8  = clip(rint(u * (1/su)), +-127)
//   out = ((T(f32(i32(u8 . w28)) * (su * s2)) + b2) + x)   each add in x's type T
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/fused_ffn.py::_ffn_kernel_int8
// (reached there through _pallas_ffn_int8, which no path of the JAX package
// dispatches).  The weights are quantized per column once, outside the
// kernel (ops/fused_ffn.py::quantize_ffn_weights), and stored transposed so
// that each output column's K values are contiguous: w1v8, w1g8 [F, d],
// w28 [d, F], int8, with float32 scales s1v, s1g [F] and s2 [d].
//
// What bounds it on this card: 6 * M * d * F integer operations against
// about M * d activation bytes and 3 * d * F weight bytes, so at the U-Net's
// shapes it is bound by operations, s8 at 1,979 TOP/s.
//
// The trouble is the row scale su: it needs the whole hidden row of F
// values (5120 f32 at d = 1280) before any of it can be quantized, and the
// rows of one block's tile (64 x 5120 x 4 bytes = 1.3 MB) do not fit in
// shared memory, where a TPU VMEM tile holds them.  The design takes three
// launches, none with atomics, so results are deterministic:
//  1. ffn8_ln_quant: one warp per row computes the LayerNorm, its row max
//     and the codes: y8 [M, d] int8 and sy [M].
//  2. ffn8_geglu: a block owns 64 whole rows and walks every 64-wide column
//     tile of F; the two s8 products (value and gate) run on mma.sync
//     m16n8k32 with s32 accumulators, and the epilogue writes u in f32 to a
//     workspace [M, F] while it keeps the row max of |u| in registers; at
//     the end the block reduces the row max and writes su [M].
//  3. ffn8_out: the second s8 product M x d x F, its A tile quantized from
//     the f32 workspace as it is loaded (u8 never reaches device memory),
//     with the dequantize, +b2 and +x epilogue.
// Launch 2 has M / 64 blocks, fewer than the card's 132 SMs below M = 8448:
// a fused or column-split design is for a later change.  Rounding follows
// the plain version (ops/fused_ffn.py::_plain_ffn_int8) operation by
// operation: explicit round-to-nearest multiplies and adds (no FMA
// contraction), rintf for half-to-even codes; only the LayerNorm's
// summation order differs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LD = BK + 16;  // smem row stride in bytes (ldmatrix without bank conflicts)
constexpr int kStages = 4;
constexpr int kMaxPerLane = 40;  // d <= 1280 in launch 1 (one warp per row)
constexpr float kInv127 = 1.0f / 127.0f;

// The JAX package's _GELU_POLY_CS (ops/fused_ffn.py), highest power last.
__constant__ float kGeluCs[10] = {
    1.17001125700400e-05f, 7.97724482796235e-01f, -1.32617207955768e-01f,
    1.96232925549133e-02f, -2.22546161701489e-03f, 1.90177605018239e-04f,
    -1.17833702310525e-05f, 4.93687027647959e-07f, -1.23685744320984e-08f,
    1.38723939155963e-10f};

__device__ __forceinline__ float gelu_poly(float x) {
  const float ax = fabsf(x);
  const float c = fminf(ax, 4.0f);
  const float t = __fmul_rn(c, c);
  float p = kGeluCs[9];
#pragma unroll
  for (int i = 8; i >= 0; --i) p = __fadd_rn(__fmul_rn(p, t), kGeluCs[i]);
  const float h = ax > 4.0f ? ax : p;
  return __fadd_rn(__fmul_rn(0.5f, x), __fmul_rn(0.5f, h));
}

__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// ---------------------------------------------------------------- launch 1
template <typename T>
__global__ void __launch_bounds__(256)
ffn8_ln_quant(const T* __restrict__ x, const float* __restrict__ lns,
              const float* __restrict__ lnb, int8_t* __restrict__ y8, float* __restrict__ sy,
              int m, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= m) return;
  const T* xr = x + (long)row * d;
  float v[kMaxPerLane];
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < d ? to_f32(xr[j]) : 0.0f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / d;
  const float var = fmaxf(__fadd_rn(s2 / d, -__fmul_rn(mu, mu)), 0.0f);
  const float rstd = 1.0f / sqrtf(var + eps);
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = lane + 32 * i;
    if (j < d) {
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mu, rstd), lns[j]), lnb[j]);
      amax = fmaxf(amax, fabsf(v[i]));
    }
  }
  amax = warp_max(amax);
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  const float inv = 1.0f / scale;
  int8_t* yr = y8 + (long)row * d;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = lane + 32 * i;
    if (j < d) yr[j] = quant(v[i], inv);
  }
  if (lane == 0) sy[row] = scale;
}

// The shared s8 tile loop: 64 x 64 outputs per block of 4 warps, each warp
// 32 x 32 (2 m16 x 4 n8 tiles), A and B in [rows][LD] byte tiles.
__device__ __forceinline__ void mma_tile(int (&acc)[2][4][4], const int8_t* a_t, const int8_t* b_t,
                                         int wm, int wn, int lane) {
  uint32_t af[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    ldsm_x4(af[i], a_t + (wm * 32 + i * 16 + lane % 16) * LD + (lane / 16) * 16);
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    uint32_t bf[4];
    ldsm_x4(bf, b_t + (wn * 32 + jp * 16 + lane % 8 + (lane / 16) * 8) * LD +
                    ((lane / 8) % 2) * 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_s8(acc[i][2 * jp], af[i], bf[0], bf[1]);
      mma_s8(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// ---------------------------------------------------------------- launch 2
__global__ void __launch_bounds__(kThreads)
ffn8_geglu(const int8_t* __restrict__ y8, const float* __restrict__ sy,
           const int8_t* __restrict__ w1v8, const float* __restrict__ s1v,
           const float* __restrict__ b1v, const int8_t* __restrict__ w1g8,
           const float* __restrict__ s1g, const float* __restrict__ b1g, float* __restrict__ u,
           float* __restrict__ su, int m, int d, int f) {
  __shared__ __align__(16) int8_t as[kStages][BM * LD];
  __shared__ __align__(16) int8_t bvs[kStages][BN * LD];
  __shared__ __align__(16) int8_t bgs[kStages][BN * LD];
  __shared__ float red[2][BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * BM;
  const int k_steps = d / BK;
  const int lrow = tid / 2, lchunk = (tid % 2) * 16;
  const bool a_ok = m0 + lrow < m;
  const int8_t* a_src = y8 + (a_ok ? (long)(m0 + lrow) * d : 0) + lchunk;

  // row max of |u| for rows (i, r): wm * 32 + i * 16 + g + 8 * r
  float rmax[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float row_sy[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mm = m0 + wm * 32 + i * 16 + g + 8 * r;
      row_sy[i][r] = mm < m ? sy[mm] : 0.0f;
    }

  for (int n0 = 0; n0 < f; n0 += BN) {
    const bool b_ok = n0 + lrow < f;
    const long b_off = (b_ok ? (long)(n0 + lrow) * d : 0) + lchunk;
    auto load_stage = [&](int stage, int ks) {
      cp_async16(&as[stage][lrow * LD + lchunk], a_src + (a_ok ? ks * BK : 0), a_ok);
      cp_async16(&bvs[stage][lrow * LD + lchunk], w1v8 + b_off + (b_ok ? ks * BK : 0), b_ok);
      cp_async16(&bgs[stage][lrow * LD + lchunk], w1g8 + b_off + (b_ok ? ks * BK : 0), b_ok);
    };
    int acc_a[2][4][4], acc_g[2][4][4];
    zero(acc_a);
    zero(acc_g);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < k_steps) load_stage(s, s);
      cp_async_commit();
    }
    for (int ks = 0; ks < k_steps; ++ks) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int next = ks + kStages - 1;
      if (next < k_steps) load_stage(next % kStages, next);
      cp_async_commit();
      const int stage = ks % kStages;
      mma_tile(acc_a, as[stage], bvs[stage], wm, wn, lane);
      mma_tile(acc_g, as[stage], bgs[stage], wm, wn, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before the next tile refills it

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int mm = m0 + wm * 32 + i * 16 + g + 8 * r;
        if (mm >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + wn * 32 + j * 8 + 2 * t4 + c;
            if (n >= f) continue;
            const int e = 2 * r + c;
            const float a = __fadd_rn(
                __fmul_rn(__int2float_rn(acc_a[i][j][e]), __fmul_rn(row_sy[i][r], s1v[n])), b1v[n]);
            const float gt = __fadd_rn(
                __fmul_rn(__int2float_rn(acc_g[i][j][e]), __fmul_rn(row_sy[i][r], s1g[n])), b1g[n]);
            const float uu = __fmul_rn(a, gelu_poly(gt));
            u[(long)mm * f + n] = uu;
            rmax[i][r] = fmaxf(rmax[i][r], fabsf(uu));
          }
        }
      }
    }
  }

  // reduce the row max over the 4 lanes of a row, then over the 2 warps wn
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = rmax[i][r];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t4 == 0) red[wn][wm * 32 + i * 16 + g + 8 * r] = v;
    }
  __syncthreads();
  if (tid < BM && m0 + tid < m) {
    const float amax = fmaxf(red[0][tid], red[1][tid]);
    su[m0 + tid] = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  }
}

// ---------------------------------------------------------------- launch 3
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn8_out(const float* __restrict__ u, const float* __restrict__ su,
         const int8_t* __restrict__ w28, const float* __restrict__ s2,
         const T* __restrict__ b2, const T* __restrict__ x, T* __restrict__ out, int m, int d,
         int f) {
  __shared__ __align__(16) int8_t as[kStages][BM * LD];
  __shared__ __align__(16) int8_t bs[kStages][BN * LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_steps = f / BK;
  const int lrow = tid / 2, lchunk = (tid % 2) * 16;
  const bool a_ok = m0 + lrow < m;
  const float* a_src = u + (a_ok ? (long)(m0 + lrow) * f : 0) + lchunk;
  const float a_inv = a_ok ? 1.0f / su[m0 + lrow] : 0.0f;
  const bool b_ok = n0 + lrow < d;
  const int8_t* b_src = w28 + (b_ok ? (long)(n0 + lrow) * f : 0) + lchunk;

  // A: 16 f32 of u quantized to 16 codes in registers, stored as 16 bytes
  auto load_stage = [&](int stage, int ks) {
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (a_ok) {
      const float4* p = reinterpret_cast<const float4*>(a_src + ks * BK);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = p[q];
        const uint32_t b0 = static_cast<uint8_t>(quant(v.x, a_inv));
        const uint32_t b1 = static_cast<uint8_t>(quant(v.y, a_inv));
        const uint32_t b2v = static_cast<uint8_t>(quant(v.z, a_inv));
        const uint32_t b3 = static_cast<uint8_t>(quant(v.w, a_inv));
        packed[q] = b0 | (b1 << 8) | (b2v << 16) | (b3 << 24);
      }
    }
    *reinterpret_cast<uint4*>(&as[stage][lrow * LD + lchunk]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    cp_async16(&bs[stage][lrow * LD + lchunk], b_src + (b_ok ? (long)ks * BK : 0), b_ok);
  };

  int acc[2][4][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = ks + kStages - 1;
    if (next < k_steps) load_stage(next % kStages, next);
    cp_async_commit();
    const int stage = ks % kStages;
    mma_tile(acc, as[stage], bs[stage], wm, wn, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mm = m0 + wm * 32 + i * 16 + g + 8 * r;
      if (mm >= m) continue;
      const float row_su = su[mm];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t4 + c;
          if (n >= d) continue;
          const float v = __fmul_rn(__int2float_rn(acc[i][j][2 * r + c]), __fmul_rn(row_su, s2[n]));
          const float o = to_f32(from_f32<T>(v));
          const float ob = to_f32(from_f32<T>(__fadd_rn(o, to_f32(b2[n]))));
          out[(long)mm * d + n] = from_f32<T>(__fadd_rn(ob, to_f32(x[(long)mm * d + n])));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* lns, const float* lnb, const int8_t* w1v8,
                   const float* s1v, const float* b1v, const int8_t* w1g8, const float* s1g,
                   const float* b1g, const int8_t* w28, const float* s2, const void* b2,
                   void* out, int8_t* y8, float* sy, float* u, float* su, int m, int d, int f,
                   float eps, cudaStream_t st) {
  ffn8_ln_quant<T><<<(m + 7) / 8, 256, 0, st>>>(static_cast<const T*>(x), lns, lnb, y8, sy, m, d,
                                                eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn8_geglu<<<(m + BM - 1) / BM, kThreads, 0, st>>>(y8, sy, w1v8, s1v, b1v, w1g8, s1g, b1g, u,
                                                     su, m, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((m + BM - 1) / BM, (d + BN - 1) / BN);
  ffn8_out<T><<<grid, kThreads, 0, st>>>(u, su, w28, s2, static_cast<const T*>(b2),
                                         static_cast<const T*>(x), static_cast<T*>(out), m, d, f);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success).  x, b2 and out have the
// activation type (is_bf16: 1 bfloat16, 0 float32); every other operand is
// float32 or int8 as named above.  Workspace from the caller: y8 [m, d]
// int8, sy [m], u [m, f] and su [m] float32.  The caller checks shapes
// (d % 32 == 0, d <= 1280, f % 32 == 0) and 16-byte alignment of y8, u and
// the int8 weights.
extern "C" int ldm_fused_ffn_int8(const void* x, const void* lns, const void* lnb,
                                  const void* w1v8, const void* s1v, const void* b1v,
                                  const void* w1g8, const void* s1g, const void* b1g,
                                  const void* w28, const void* s2, const void* b2, void* out,
                                  void* y8, void* sy, void* u, void* su, int m, int d, int f,
                                  float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto s8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  cudaError_t err =
      is_bf16 ? launch<bf16>(x, f32(lns), f32(lnb), s8(w1v8), f32(s1v), f32(b1v), s8(w1g8),
                             f32(s1g), f32(b1g), s8(w28), f32(s2), b2, out,
                             static_cast<int8_t*>(y8), static_cast<float*>(sy),
                             static_cast<float*>(u), static_cast<float*>(su), m, d, f, eps, st)
              : launch<float>(x, f32(lns), f32(lnb), s8(w1v8), f32(s1v), f32(b1v), s8(w1g8),
                              f32(s1g), f32(b1g), s8(w28), f32(s2), b2, out,
                              static_cast<int8_t*>(y8), static_cast<float*>(sy),
                              static_cast<float*>(u), static_cast<float*>(su), m, d, f, eps, st);
  return static_cast<int>(err);
}
