// Flash-attention forward with the P.V product in int8, for Hopper (sm_90a).
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/flash_attention.py::_flash_kernel
// with pv_int8=True (the serving mode tpu.quantize_attention: int8pv).  Its
// results are defined by the TPU kernel's kv blocks, so this kernel keeps
// them as units of arithmetic ("JAX blocks" of bkj keys, from
// ops/flash_attention.py::jax_block_k), whatever tiles it loads:
//
//  * v is quantized per (b, h, JAX block): sv = max(amax |v|, 1e-8) / 127,
//    v8 = clip(rint(v * (1 / sv)), -127, 127).  A pre-pass kernel computes
//    sv for every block.
//  * p is quantized against the running row max up to and including the
//    JAX block: a first sweep over the block's tiles computes the block's
//    row max (Q K^T only), a second recomputes Q K^T, takes
//    p = exp(s - m), p8 = rint(127 p), adds the dequantized p8 / 127 to the
//    normalizer l, and accumulates the s32 products p8 . v8 over the whole
//    block.  Only then is the block folded in:
//      acc = acc * alpha + float(pv) * (sv / 127),  l = l * alpha + sum(p8) / 127.
//  * keys past the end (the ragged tail) contribute nothing: p8 = 0, v8 = 0.
//
// Layout: q, o [B, Tq, H, S]; k, v [B, Tk, H, S], contiguous, read in place.
//
// What bounds it on this card: operations.  Q K^T is computed twice per
// key (the price of the JAX block's row max, accepted in this first
// version) and P.V once, against 2 (Tq + Tk) S elements moved.
//
// Tensor-core path (bf16, S % 8 == 0, S <= 160; the U-Net's level-0 S = 40):
// 4 warps each own 16 query rows of a 64-row tile.  Q K^T runs on mma.sync
// m16n8k16 bf16 (f32 accumulators, scaled after the product), P.V on
// mma.sync m16n8k32 s8 with s32 accumulators.  p8 goes from the score
// accumulators straight into s8 A fragments without shuffles: P.V sums over
// keys, so any order of the 32 keys of a k-step serves if v8 uses the same
// one, and v8 is written to shared memory [dim][key] in the order in which
// each thread already holds its p8 (slot 4t + e of half u holds key
// 8 (2u + e / 2) + 2t + e % 2).  Rows of 80 bytes keep those 4-byte reads
// free of bank conflicts.
//
// FMA path (float32 inputs, and bf16 heads the tensor-core path does not
// take, such as the autoencoder's single 512-wide head): scores in float32
// through shared memory with q scaled before the product, as the TPU kernel
// does; p8 and v8 are small integers, so their tile products are exact in
// float32 and are added to an s32 accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 128;
constexpr float kInv127 = 1.f / 127.f;

// ------------------------------------------------------------- v scales

template <typename T>
__global__ void __launch_bounds__(256)
v_scale_kernel(const T* __restrict__ v, float* __restrict__ sv, int tk, int h, int s, int bkj) {
  __shared__ float red[8];
  const int jb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const long tok = (long)h * s;
  const T* vb = v + (long)b * tk * tok + (long)head * s;
  const int k0 = jb * bkj, k1 = min(k0 + bkj, tk);
  const long n = (long)(k1 - k0) * s;
  float m = 0.f;
  for (long i = threadIdx.x; i < n; i += 256) {
    const long r = i / s;
    m = fmaxf(m, fabsf(to_f32(vb[(k0 + r) * tok + (i - r * s)])));
  }
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w]);
    sv[(long)bh * gridDim.x + jb] = __fmul_rn(fmaxf(m, 1e-8f), kInv127);
  }
}

__device__ __forceinline__ int quantize_v(float x, float inv_sv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(x, inv_sv)), -127.f), 127.f);
}

// ---------------------------------------------------------------- FMA path

template <int BQ, int BK>
size_t fma_smem_bytes(int s) {
  return (size_t)s * BQ * 4           // q * scale, transposed [s][BQ]
         + (size_t)BK * (s + 1) * 4   // k [BK][s+1]
         + (size_t)BQ * (BK + 1) * 4  // scores, then p8 [BQ][BK+1]
         + (size_t)BQ * s * 4         // output accumulator [BQ][s]
         + (size_t)BQ * s * 4         // s32 P.V of the current JAX block [BQ][s]
         + 4 * BQ * 4                 // m, l, alpha, block max
         + (size_t)BK * s;            // v8 [BK][s]
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
pv_int8_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ sv, T* __restrict__ o, int tq, int tk, int h, int s,
                   float scale, int bkj) {
  extern __shared__ __align__(16) float smem[];
  const int sk = s + 1;
  float* qs = smem;                 // [s][BQ]
  float* ks = qs + s * BQ;          // [BK][s+1]
  float* ps = ks + BK * sk;         // [BQ][BK+1]
  float* os = ps + BQ * (BK + 1);   // [BQ][s]
  int* pvs = reinterpret_cast<int*>(os + BQ * s);  // [BQ][s]
  float* m_s = reinterpret_cast<float*>(pvs + BQ * s);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  float* mb_s = a_s + BQ;
  int8_t* v8s = reinterpret_cast<int8_t*>(mb_s + BQ);  // [BK][s]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int q0 = blockIdx.x * BQ;
  const long tok = (long)h * s;
  const T* qb = q + (long)b * tq * tok + (long)head * s;
  const T* kb = k + (long)b * tk * tok + (long)head * s;
  const T* vb = v + (long)b * tk * tok + (long)head * s;
  T* ob = o + (long)b * tq * tok + (long)head * s;
  const int nblk = (tk + bkj - 1) / bkj;

  for (int i = tid; i < BQ * s; i += kThreads) {
    const int r = i / s, c = i % s, t = q0 + r;
    qs[c * BQ + r] = t < tq ? __fmul_rn(to_f32(qb[t * tok + c]), scale) : 0.f;
    os[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  constexpr int kGroups = kThreads / BK;
  constexpr int RPT = BQ / kGroups;
  static_assert(kThreads % BK == 0 && BQ % kGroups == 0, "tile shape");
  const int col = tid % BK;
  const int r0 = (tid / BK) * RPT;

  // scores of the tile at k0 into ps (keys past tk are -inf)
  auto scores = [&](int k0) {
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
    const float* krow = ks + col * sk;
    for (int c = 0; c < s; ++c) {
      const float kv = krow[c];
      const float* qc = qs + c * BQ + r0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = fmaf(qc[j], kv, acc[j]);
    }
    const bool valid = k0 + col < tk;
#pragma unroll
    for (int j = 0; j < RPT; ++j) ps[(r0 + j) * (BK + 1) + col] = valid ? acc[j] : -INFINITY;
  };
  auto load_k = [&](int k0) {
    for (int i = tid; i < BK * s; i += kThreads) {
      const int r = i / s, c = i % s, t = k0 + r;
      ks[r * sk + c] = t < tk ? to_f32(kb[t * tok + c]) : 0.f;
    }
  };

  for (int jb = 0; jb < nblk; ++jb) {
    const int kb0 = jb * bkj, kb1 = min(kb0 + bkj, tk);
    // sweep 1: the JAX block's row max
    for (int r = tid; r < BQ; r += kThreads) mb_s[r] = -INFINITY;
    for (int k0 = kb0; k0 < kb1; k0 += BK) {
      __syncthreads();
      load_k(k0);
      __syncthreads();
      scores(k0);
      __syncthreads();
      for (int r = warp; r < BQ; r += kThreads / 32) {
        float mx = -INFINITY;
        for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[r * (BK + 1) + j]);
        mx = warp_max(mx);
        if (lane == 0) mb_s[r] = fmaxf(mb_s[r], mx);
      }
    }
    __syncthreads();
    for (int r = tid; r < BQ; r += kThreads) {
      const float m_new = fmaxf(m_s[r], mb_s[r]);
      const float alpha = expf(m_s[r] - m_new);
      a_s[r] = alpha;
      l_s[r] *= alpha;
      m_s[r] = m_new;
    }
    for (int i = tid; i < BQ * s; i += kThreads) pvs[i] = 0;
    const float inv_sv = __frcp_rn(sv[(long)bh * nblk + jb]);
    // sweep 2: p8, l and the s32 P.V of the block
    for (int k0 = kb0; k0 < kb1; k0 += BK) {
      __syncthreads();
      load_k(k0);
      for (int i = tid; i < BK * s; i += kThreads) {
        const int r = i / s, c = i % s, t = k0 + r;
        v8s[i] = (int8_t)(t < tk ? quantize_v(to_f32(vb[t * tok + c]), inv_sv) : 0);
      }
      __syncthreads();
      scores(k0);
      __syncthreads();
      for (int r = warp; r < BQ; r += kThreads / 32) {
        float* prow = ps + r * (BK + 1);
        const float m = m_s[r];
        float sum = 0.f;
        for (int j = lane; j < BK; j += 32) {
          const float p8 = k0 + j < tk ? rintf(__fmul_rn(expf(prow[j] - m), 127.f)) : 0.f;
          prow[j] = p8;
          sum += __fmul_rn(p8, kInv127);
        }
        sum = warp_sum(sum);
        if (lane == 0) l_s[r] += sum;
      }
      __syncthreads();
      for (int i = tid; i < BQ * s; i += kThreads) {
        const int r = i / s, c = i % s;
        const float* prow = ps + r * (BK + 1);
        float pv = 0.f;  // exact: |sum| <= BK * 127 * 127 < 2^24
        for (int j = 0; j < BK; ++j) pv = fmaf(prow[j], (float)v8s[j * s + c], pv);
        pvs[i] += (int)pv;
      }
    }
    __syncthreads();
    const float svs = __fmul_rn(sv[(long)bh * nblk + jb], kInv127);
    for (int i = tid; i < BQ * s; i += kThreads)
      os[i] = __fadd_rn(__fmul_rn(os[i], a_s[i / s]), __fmul_rn((float)pvs[i], svs));
  }
  __syncthreads();
  for (int i = tid; i < BQ * s; i += kThreads) {
    const int r = i / s, c = i % s, t = q0 + r;
    if (t < tq) ob[t * tok + c] = from_f32<T>(os[i] / l_s[r]);
  }
}

template <typename T, int BQ, int BK>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const float* sv, void* o,
                       int b, int tq, int tk, int h, int s, float scale, int bkj,
                       cudaStream_t stream) {
  const size_t bytes = fma_smem_bytes<BQ, BK>(s);
  cudaError_t err = cudaFuncSetAttribute(pv_int8_fma_kernel<T, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BQ - 1) / BQ, b * h);
  pv_int8_fma_kernel<T, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), sv,
      static_cast<T*>(o), tq, tk, h, s, scale, bkj);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* q, const void* k, const void* v, const float* sv, void* o,
                         int b, int tq, int tk, int h, int s, float scale, int bkj,
                         cudaStream_t st) {
  if (s <= 160) return launch_fma<T, 64, 64>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
  return launch_fma<T, 16, 32>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
}

// ------------------------------------------------------ tensor-core path

constexpr int kRows = 64;  // query rows per block: 4 warps x 16
constexpr int kKeys = 64;  // keys per tile
constexpr int kLDV = kKeys + 16;  // v8 row stride in bytes

template <int SP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kRows + kKeys) * (SP + 8) * sizeof(bf16) + (size_t)SP * kLDV;
}

// SP: the head dim rounded up to a multiple of 16 (the bf16 mma k-step).
template <int SP>
__global__ void __launch_bounds__(kThreads)
pv_int8_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ sv,
                   bf16* __restrict__ o, int tq, int tk, int h, int s, float scale, int bkj) {
  constexpr int LD = SP + 8;  // bf16 row stride (16 bytes of pad)
  constexpr int KS = SP / 16;
  constexpr int CH = SP / 8;  // 16-byte chunks per row
  constexpr int NT = SP / 8;  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ksm = qs + kRows * LD;
  int8_t* v8t = reinterpret_cast<int8_t*>(ksm + kKeys * LD);  // [SP][kLDV]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int q0 = blockIdx.x * kRows;
  const long tok = (long)h * s;
  const bf16* qb = q + (long)b * tq * tok + (long)head * s;
  const bf16* kb = k + (long)b * tk * tok + (long)head * s;
  const bf16* vb = v + (long)b * tk * tok + (long)head * s;
  bf16* ob = o + (long)b * tq * tok + (long)head * s;
  const int nblk = (tk + bkj - 1) / bkj;

  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8, t = q0 + r;
    const bool ok = t < tq && c < s;
    cp_async16(qs + r * LD + c, qb + (ok ? (long)t * tok + c : 0), ok);
  }
  cp_async_commit();
  auto load_k = [&](int k0) {
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8, t = k0 + r;
      const bool ok = t < tk && c < s;
      cp_async16(ksm + r * LD + c, kb + (ok ? (long)t * tok + c : 0), ok);
    }
    cp_async_commit();
  };
  // S = Q K^T * scale for this warp's 16 rows and the tile's 64 keys;
  // keys past tk are -inf.
  uint32_t qf[KS][4];
  auto scores = [&](float (&sacc)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ksm + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                        ((lane / 8) % 2) * 8);
        mma_bf16(sacc[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(sacc[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
    const int key0 = k0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[j][e] = key0 + j * 8 + (e & 1) < tk ? __fmul_rn(sacc[j][e], scale) : -INFINITY;
  };

  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // rows g and g+8 of this warp's 16: running max, and this thread's share
  // of the running sum (the quad's four add up at the end)
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int jb = 0; jb < nblk; ++jb) {
    const int kb0 = jb * bkj, kb1 = min(kb0 + bkj, tk);
    // sweep 1: the JAX block's row max
    float mx[2] = {-INFINITY, -INFINITY};
    for (int k0 = kb0; k0 < kb1; k0 += kKeys) {
      __syncthreads();  // every warp is done with the previous tile
      load_k(k0);
      cp_async_wait<0>();
      __syncthreads();
      float sacc[8][4];
      scores(sacc, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sacc[j][e]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }

    // sweep 2: p8, l and the s32 P.V of the block
    const float sv_blk = sv[(long)bh * nblk + jb];
    const float inv_sv = __frcp_rn(sv_blk);
    int pv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0;
    float lsum[2] = {0.f, 0.f};
    for (int k0 = kb0; k0 < kb1; k0 += kKeys) {
      __syncthreads();
      load_k(k0);
      // v8 [dim][slot]: key r of the tile (32-key step u = r / 32, rr = r % 32)
      // goes to slot 16 (rr / 16) + 4 ((rr % 8) / 2) + 2 ((rr / 8) % 2) + rr % 2.
      for (int i = tid; i < kKeys * SP; i += kThreads) {
        const int r = i / SP, c = i % SP, t = k0 + r;
        const int rr = r % 32;
        const int slot = (r / 32) * 32 + (rr / 16) * 16 + ((rr % 8) / 2) * 4 + ((rr / 8) % 2) * 2 +
                         rr % 2;
        const int val = t < tk && c < s ? quantize_v(__bfloat162float(vb[t * tok + c]), inv_sv) : 0;
        v8t[c * kLDV + slot] = (int8_t)val;
      }
      cp_async_wait<0>();
      __syncthreads();
      float sacc[8][4];
      scores(sacc, k0);
      uint32_t pa[2][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int p8[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sacc[j][e] - m_r[e / 2]);  // -inf -> 0
          const float r8 = rintf(__fmul_rn(p, 127.f));
          lsum[e / 2] += __fmul_rn(r8, kInv127);
          p8[e] = (int)r8;
        }
        // n-tile j holds keys 8j + 2t4 + {0, 1}: bytes (j % 2) * 2 + {0, 1}
        // of register (j / 2) % 2 * 2 + {0 (row g), 1 (row g + 8)} of step j / 4.
        const int kk = j / 4, reg = ((j / 2) % 2) * 2, sh = (j % 2) * 16;
        const uint32_t lo = (uint32_t)(p8[0] | (p8[1] << 8)) << sh;
        const uint32_t hi = (uint32_t)(p8[2] | (p8[3] << 8)) << sh;
        if (sh == 0) {
          pa[kk][reg] = lo;
          pa[kk][reg + 1] = hi;
        } else {
          pa[kk][reg] |= lo;
          pa[kk][reg + 1] |= hi;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int8_t* vrow = v8t + (n * 8 + g) * kLDV + kk * 32 + 4 * t4;
          mma_s8(pv[n], pa[kk], *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 16));
        }
      }
    }
    const float svs = __fmul_rn(sv_blk, kInv127);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), lsum[r]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[n][e] = __fadd_rn(__fmul_rn(oacc[n][e], alpha[e / 2]),
                               __fmul_rn(__int2float_rn(pv[n][e]), svs));
  }

  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_tot[r] = l;
  }
  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c >= s) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row + 8 * r;
      if (t < tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)t * tok + c) = __floats2bfloat162_rn(
            __fdiv_rn(oacc[n][2 * r], l_tot[r]), __fdiv_rn(oacc[n][2 * r + 1], l_tot[r]));
    }
  }
}

template <int SP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* sv, void* o,
                       int b, int tq, int tk, int h, int s, float scale, int bkj,
                       cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<SP>();
  cudaError_t err = cudaFuncSetAttribute(pv_int8_mma_kernel<SP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kRows - 1) / kRows, b * h);
  pv_int8_mma_kernel<SP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), sv,
      static_cast<bf16*>(o), tq, tk, h, s, scale, bkj);
  return cudaGetLastError();
}

bool takes_mma(const void* q, const void* k, const void* v, const void* o, int s) {
  return s % 8 == 0 && s <= 160 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, const float* sv, void* o,
                         int b, int tq, int tk, int h, int s, float scale, int bkj,
                         cudaStream_t st) {
  switch ((s + 15) / 16) {
    case 1: return launch_mma<16>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
    case 2: return launch_mma<32>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
    case 3: return launch_mma<48>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
    case 4: return launch_mma<64>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
    case 5: return launch_mma<80>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
    case 6: case 7: case 8: return launch_mma<128>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
    default: return launch_mma<160>(q, k, v, sv, o, b, tq, tk, h, s, scale, bkj, st);
  }
}

template <typename T>
cudaError_t v_scales(const void* v, float* sv, int b, int tk, int h, int s, int bkj,
                     cudaStream_t st) {
  const dim3 grid((tk + bkj - 1) / bkj, b * h);
  v_scale_kernel<T><<<grid, 256, 0, st>>>(static_cast<const T*>(v), sv, tk, h, s, bkj);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16
// operands, 0 for float32.  sv: float32 scratch of B * H * ceil(tk / bkj)
// values.  bkj: the JAX block, a multiple of 64.  The caller checks shapes
// (s <= 512, tk >= 1).
extern "C" int ldm_flash_attention_pv_int8_fwd(const void* q, const void* k, const void* v,
                                               void* o, void* sv, int b, int tq, int tk, int h,
                                               int s, float scale, int bkj, int is_bf16,
                                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* svf = static_cast<float*>(sv);
  cudaError_t err = is_bf16 ? v_scales<bf16>(v, svf, b, tk, h, s, bkj, st)
                            : v_scales<float>(v, svf, b, tk, h, s, bkj, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!is_bf16)
    err = dispatch_fma<float>(q, k, v, svf, o, b, tq, tk, h, s, scale, bkj, st);
  else if (takes_mma(q, k, v, o, s))
    err = dispatch_mma(q, k, v, svf, o, b, tq, tk, h, s, scale, bkj, st);
  else
    err = dispatch_fma<bf16>(q, k, v, svf, o, b, tq, tk, h, s, scale, bkj, st);
  return static_cast<int>(err);
}
