// Flash-attention forward with the P.V product in int8, for Hopper (sm_90a).
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/flash_attention.py::_flash_kernel
// with pv_int8=True (the serving mode tpu.quantize_attention: int8pv).  Its
// results are defined by the TPU kernel's kv blocks, so this kernel keeps
// them as units of arithmetic ("JAX blocks" of bkj keys, a multiple of 128,
// from ops/flash_attention.py::jax_block_k), whatever tiles it loads:
//
//  * v is quantized per (b, h, JAX block): sv = max(amax |v|, 1e-8) / 127,
//    v8 = clip(rint(v * (1 / sv)), -127, 127).
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
// key (the price of knowing the JAX block's row max before p is
// quantized) and P.V once, against 2 (Tq + Tk) S elements moved.
//
// A pre-pass (v_quant_kernel, one launch) computes sv for every JAX block
// and, for the wgmma path, writes v8 once: a cluster of 8 CTAs per (b * h,
// JAX block) takes the amax through distributed shared memory, then each
// CTA quantizes its share of the block.
//
// wgmma path (bf16 at the models' head dims: the U-Net's 40, 80, 160 and
// the autoencoder's 512; the launch geometry is the wrapper's
// wgmma_geometry("pv8", s) and must match an instantiation below):
//  * v8 is laid out as the K-major B operand of the s8 wgmma, which takes
//    no transposed s8 operand: [B * H, S_pad, Tk_pad] int8, keys contiguous,
//    S_pad the head dim padded to whole wgmma N slices (40 -> 48: N = 40 is
//    not an s8 shape), Tk_pad = Tk rounded up to 128, zeros past Tk and S.
//    Inside each 32-key k-step the keys are permuted so that the thread
//    holding score columns {8j + 2t, 8j + 2t + 1} of the step finds them at
//    the A-fragment bytes it packs them into, with no shuffles: byte 4t + e
//    of half u of the step holds key 8 (2u + e / 2) + 2t + e % 2.
//  * a producer warp issues TMA loads: the CTA's Q tile once, 64-key K tiles
//    (4-D maps over [B, T, H, S], zero-filling columns past S and rows past
//    T) into one ring, 128-key v8 tiles (a 3-D map, 128-byte swizzle) into
//    another; consumer warpgroups of 64 query rows release each stage.
//  * sweep 1: S = Q K^T on bf16 wgmma m64n64k16 (SS), the row max only;
//    sweep 2: S again, p8 = rint(127 exp2(s log2(e) - m)) packed from the
//    score accumulator straight into the s8 A fragment, P.V on wgmma
//    m64nNk32 s32.s8.s8 (A from registers) accumulating s32 over the whole
//    JAX block; exp2 on the special-function unit (ex2.approx.ftz), the
//    rounding to an integer by a float add (no conversion instruction).
//  * S = 512: a 64 x 512 s32 accumulator beside the float one would take
//    512 registers a thread, so the output's columns are split over 4 CTAs
//    (blockIdx.z, 128 columns each), each recomputing both sweeps of the
//    scores; Q (64 KB) stays resident beside two stages of 64-key K tiles
//    (64 KB each) and of 128-key v8 tiles (16 KB each).
//
// mma.sync path (bf16 head dims with no wgmma geometry: S % 8 == 0, S <=
// 160, 16-byte aligned operands): 4 warps each own 16 query rows of a
// 64-row tile.  Q K^T on mma.sync m16n8k16 bf16, P.V on mma.sync m16n8k32
// s8 with s32 accumulators; p8 goes from the score accumulators into s8 A
// fragments by the same key permutation, v8 is quantized from v into shared
// memory [dim][key] by every CTA.
//
// FMA path (float32 inputs, and bf16 heads no other path takes): scores in
// float32 through shared memory with q scaled before the product, as the
// TPU kernel does; p8 and v8 are small integers, so their tile products are
// exact in float32 and are added to an s32 accumulator.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 128;
constexpr float kInv127 = 1.f / 127.f;
constexpr float kRoundToInt = 12582912.f;  // 1.5 * 2^23

__device__ __forceinline__ int quantize_v(float x, float inv_sv) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(x, inv_sv)), -127.f), 127.f);
}

// ------------------------------------------------------------ pre-pass

constexpr int kVqThreads = 256;
constexpr int kVqCluster = 8;  // CTAs per (b * h, JAX block)
constexpr int kStep = 32;      // keys per s8 k-step

// A cluster per (b * h, JAX block jb): blockIdx.x = jb * 8 + rank.  Work
// units are (k-step, column) pairs of the block's v8 rows: 32 keys of one
// column.  Phase 1: the amax over the block (each CTA its units, then the
// cluster's 8 partial maxima through distributed shared memory; max is
// order-free, so every CTA gets the same sv), written by rank 0.  Phase 2,
// only when v8 is given: each unit's 32 codes, in the permuted key order,
// as two 16-byte stores into row c of v8 [B * H, s_pad, tk_pad]; columns
// past S and keys past Tk are written as zeros.
template <typename T>
__global__ void __cluster_dims__(kVqCluster, 1, 1) __launch_bounds__(kVqThreads)
v_quant_kernel(const T* __restrict__ v, float* __restrict__ sv, int8_t* __restrict__ v8,
               int tk, int h, int s, int bkj, int s_pad, int tk_pad) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float red[kVqThreads / 32];
  __shared__ float part;
  const int rank = (int)cluster.block_rank();
  const int jb = blockIdx.x / kVqCluster, bh = blockIdx.y;
  const int nblk = gridDim.x / kVqCluster;
  const int b = bh / h, head = bh % h;
  const long tok = (long)h * s;
  const T* vb = v + (long)b * tk * tok + (long)head * s;
  const int kb0 = jb * bkj, kb1 = min(kb0 + bkj, tk);
  // the block's k-steps up to its last 128-key v8 tile
  const int steps = ((kb1 - kb0 + 127) / 128) * (128 / kStep);
  const int cols = v8 != nullptr ? s_pad : s;
  const int units = steps * cols;
  const int stride = kVqThreads * kVqCluster;
  const int first = rank * kVqThreads + threadIdx.x;

  float m = 0.f;
  for (int u = first; u < units; u += stride) {
    const int step = u / cols, c = u % cols;
    if (c >= s) continue;
    const int key0 = kb0 + step * kStep;
    const int n = min(kStep, kb1 - key0);
    for (int r = 0; r < n; ++r) m = fmaxf(m, fabsf(to_f32(vb[(key0 + r) * tok + c])));
  }
  m = warp_max(m);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
    for (int w = 1; w < kVqThreads / 32; ++w) t = fmaxf(t, red[w]);
    part = t;
  }
  cluster.sync();
  float amax = 0.f;
  for (int r = 0; r < kVqCluster; ++r) amax = fmaxf(amax, *cluster.map_shared_rank(&part, r));
  cluster.sync();  // every CTA has read every partial before any exits
  const float svb = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  if (rank == 0 && threadIdx.x == 0) sv[(long)bh * nblk + jb] = svb;
  if (v8 == nullptr) return;

  const float inv_sv = __frcp_rn(svb);
  for (int u = first; u < units; u += stride) {
    const int step = u / cols, c = u % cols;
    const int key0 = kb0 + step * kStep;
    const int n = c < s ? min(kStep, max(kb1 - key0, 0)) : 0;
    int q8[kStep];
#pragma unroll
    for (int r = 0; r < kStep; ++r)
      q8[r] = r < n ? quantize_v(to_f32(vb[(key0 + r) * tok + c]), inv_sv) : 0;
    // word w (bytes 4w..4w+3, half u = w / 4, t = w % 4) holds keys
    // 16u + 2t, 16u + 2t + 1, 16u + 8 + 2t, 16u + 9 + 2t
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k0 = 16 * (i / 4) + 2 * (i % 4);
      w[i] = (uint32_t)(q8[k0] & 0xff) | (uint32_t)(q8[k0 + 1] & 0xff) << 8 |
             (uint32_t)(q8[k0 + 8] & 0xff) << 16 | (uint32_t)(q8[k0 + 9] & 0xff) << 24;
    }
    uint4* dst = reinterpret_cast<uint4*>(v8 + ((long)bh * s_pad + c) * tk_pad + key0);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// sv [B * H, nblk] and, when v8 is not null, v8 [B * H, s_pad, tk_pad].
template <typename T>
cudaError_t v_quant(const void* v, float* sv, int8_t* v8, int b, int tk, int h, int s, int bkj,
                    int s_pad, int tk_pad, cudaStream_t st) {
  const dim3 grid(kVqCluster * ((tk + bkj - 1) / bkj), b * h);
  v_quant_kernel<T><<<grid, kVqThreads, 0, st>>>(static_cast<const T*>(v), sv, v8, tk, h, s, bkj,
                                                 s_pad, tk_pad);
  return cudaGetLastError();
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

// ------------------------------------------------------ mma.sync path
//
// bf16 head dims that have no wgmma geometry (S % 8 == 0, S <= 160, not 40,
// 80 or 160; and those three when an operand is not 16-byte aligned).

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

// ------------------------------------------------------------ wgmma path

// KSTEPS k-steps of 16 head-dim columns in Q K^T; NO output columns per CTA
// (blockIdx.z selects the slice; a wgmma s8 N); NWG consumer warpgroups of
// 64 query rows each; STAGES stages in each ring (64-key K tiles, 128-key
// v8 tiles).
template <int KSTEPS, int NO, int NWG, int STAGES, int CTAS>
struct Pv8Wgmma {
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = 64;   // keys per K tile
  static constexpr int VK = 128;  // keys per v8 tile: one 128-byte row per output column
  static constexpr int KCH = (KSTEPS * 16 + 63) / 64;  // 64-column chunks of Q and K
  static constexpr int Q_BYTES = KCH * BQ * 128;
  static constexpr int K_BYTES = KCH * BK * 128;
  static constexpr int V_BYTES = NO * VK;
  static constexpr int THREADS = NWG * 128 + 32;  // + one producer warp
  // 1024 bytes to align the dynamic base, the tiles, 128 bytes of barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 128;
  static_assert(1 + 4 * STAGES <= 16, "barrier space");
  static_assert(NO % 16 == 0 && NO <= 256, "an s8 wgmma N");
};

template <int KSTEPS, int NO, int NWG, int STAGES, int CTAS>
__global__ void __launch_bounds__(NWG * 128 + 32, CTAS)
pv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap v8map, const float* __restrict__ sv,
                     bf16* __restrict__ o, int tq, int tk, int h, int s, float scale_log2,
                     int bkj) {
  using C = Pv8Wgmma<KSTEPS, NO, NWG, STAGES, CTAS>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + C::Q_BYTES;           // the K ring
  unsigned char* vs = ks + STAGES * C::K_BYTES;  // the v8 ring
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * C::V_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / h, head = bh % h;
  const int q0 = blockIdx.x * C::BQ;
  const int n0 = blockIdx.z * NO;
  const int nblk = (tk + bkj - 1) / bkj;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], NWG * 128);
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_load_tile(qs, &qmap, q_full, 0, C::KCH, C::BQ, head, q0, b);
      int kn = 0, vn = 0;  // tiles issued into each ring
      auto load_k = [&](int key0) {
        const int st = kn % STAGES;
        mbar_wait(&k_empty[st], ((kn / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[st], C::K_BYTES);
        tma_load_tile(ks + st * C::K_BYTES, &kmap, &k_full[st], 0, C::KCH, C::BK, head, key0, b);
        ++kn;
      };
      for (int jb = 0; jb < nblk; ++jb) {
        const int kb0 = jb * bkj, kb1 = min(kb0 + bkj, tk);
        for (int k0 = kb0; k0 < kb1; k0 += C::BK) load_k(k0);  // sweep 1
        for (int k0 = kb0; k0 < kb1; k0 += C::BK) {            // sweep 2
          if ((k0 - kb0) % C::VK == 0) {
            const int st = vn % STAGES;
            mbar_wait(&v_empty[st], ((vn / STAGES) & 1) ^ 1);
            mbar_expect_tx(&v_full[st], C::V_BYTES);
            tma_load_3d(vs + st * C::V_BYTES, &v8map, &v_full[st], k0, n0, bh);
            ++vn;
          }
          load_k(k0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64wg ..; this thread's rows
  // are r0 + g and r0 + g + 8
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16;
  const uint32_t qs_a = smem_u32(qs);
  float oacc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) oacc[i] = 0.f;
  // running max (log2 units) and this thread's share of the running sum
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  int kn = 0, vn = 0;  // tiles consumed from each ring
  mbar_wait(q_full, 0);

  // raw scores Q K^T (64 x 64 per warpgroup) of the next K tile; its stage
  // is released as soon as the product has completed
  auto scores = [&](float (&sacc)[32]) {
    const int st = kn % STAGES;
    mbar_wait(&k_full[st], (kn / STAGES) & 1);
    const uint32_t ks_a = smem_u32(ks + st * C::K_BYTES);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaSS<64>::run(sacc, desc_kmajor(qs_a, C::BQ, wg * 64, kk),
                       desc_kmajor(ks_a, C::BK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    mbar_arrive(&k_empty[st]);
    ++kn;
  };

  for (int jb = 0; jb < nblk; ++jb) {
    const int kb0 = jb * bkj, kb1 = min(kb0 + bkj, tk);
    // sweep 1: the JAX block's row max, on the raw scores (the scale is
    // positive); element i of a tile is key 8 (i / 4) + 2 t4 + (i & 1)
    float mx[2] = {-INFINITY, -INFINITY};
    for (int k0 = kb0; k0 < kb1; k0 += C::BK) {
      float sacc[32];
      scores(sacc);
      const int key0 = k0 + 2 * t4;
      const bool ragged = k0 + C::BK > tk;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!ragged || key0 + (i / 4) * 8 + (i & 1) < tk)
          mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sacc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
      alpha[r] = ex2(m_r[r] - m_new);  // 0 for the first block
      m_r[r] = m_new;
    }

    // sweep 2: p8, its sum and the s32 P.V of the block
    int pv[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) pv[i] = 0;
    int psum[2] = {0, 0};
    for (int k0 = kb0; k0 < kb1; k0 += C::BK) {
      const int half = (k0 - kb0) / C::BK % 2;  // which half of the v8 tile
      const int vst = vn % STAGES;
      if (half == 0) mbar_wait(&v_full[vst], (vn / STAGES) & 1);
      const uint32_t vs_a = smem_u32(vs + vst * C::V_BYTES);
      float sacc[32];
      scores(sacc);
      const int key0 = k0 + 2 * t4;
      const bool ragged = k0 + C::BK > tk;
      // A register r of 32-key step kk: row g + 8 (r % 2), n8 blocks
      // j = 4kk + 2 (r / 2) + {0, 1}, two keys of each (see the header).
      // rint(127 p) without a conversion instruction: 127 p + 1.5 * 2^23
      // rounds to an integer half to even, as rint does, and that integer
      // (at most 127) is the sum's low byte; three byte permutes pack four
      // of them, one dp4a adds them to the row's sum of p8.
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t b[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * kk + 2 * (r / 2) + e / 2;
            const int i = 4 * j + 2 * (r % 2) + e % 2;
            const float x = !ragged || key0 + 8 * j + e % 2 < tk
                                ? fmaf(sacc[i], scale_log2, -m_r[r % 2])
                                : -INFINITY;  // 2^-inf = 0: p8 = 0
            b[e] = __float_as_uint(__fadd_rn(__fmul_rn(ex2(x), 127.f), kRoundToInt));
          }
          pa[kk][r] = __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                                  __byte_perm(b[2], b[3], 0x0040), 0x5410);
          psum[r % 2] = __dp4a((int)pa[kk][r], 0x01010101, psum[r % 2]);
        }
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        WgmmaS8RS<NO>::run(pv, pa[kk], desc_kmajor(vs_a, NO, 0, 2 * half + kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      if (half == 1 || k0 + C::BK >= kb1) {  // the v8 tile's last K tile
        mbar_arrive(&v_empty[vst]);
        ++vn;
      }
    }
    // fold the block in: acc = acc * alpha + float(pv) * (sv / 127)
    const float svs = __fmul_rn(sv[(long)bh * nblk + jb], kInv127);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), __fmul_rn((float)psum[r], kInv127));
#pragma unroll
    for (int i = 0; i < NO / 2; ++i)
      oacc[i] = __fadd_rn(__fmul_rn(oacc[i], alpha[(i % 4) / 2]),
                          __fmul_rn(__int2float_rn(pv[i]), svs));
  }

  const long tok = (long)h * s;
  bf16* ob = o + (long)b * tq * tok + (long)head * s;
  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_tot[r] = l;
  }
#pragma unroll
  for (int n = 0; n < NO / 8; ++n) {
    const int c = n0 + n * 8 + 2 * t4;
    if (c >= s) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + g + 8 * r;
      if (t < tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)t * tok + c) =
            __floats2bfloat162_rn(__fdiv_rn(oacc[4 * n + 2 * r], l_tot[r]),
                                  __fdiv_rn(oacc[4 * n + 2 * r + 1], l_tot[r]));
    }
  }
}

// geometry: {rows per CTA, keys per K tile, output columns per CTA, stages,
// dynamic shared bytes, CTAs per SM}, from ops/flash_attention.py's
// wgmma_geometry("pv8", s); a geometry this build does not hold is refused.
template <int KSTEPS, int NO, int NWG, int STAGES, int CTAS>
bool pv8_geometry_is(const int* geo, int s) {
  using C = Pv8Wgmma<KSTEPS, NO, NWG, STAGES, CTAS>;
  return geo[0] == C::BQ && geo[1] == C::BK && geo[2] == NO && geo[3] == STAGES &&
         geo[4] == C::SMEM && geo[5] == CTAS && KSTEPS == (s + 15) / 16;
}

// The columns of v8's rows: Tk rounded up to whole 128-key v8 tiles.
int v8_keys(int tk) { return (tk + 127) / 128 * 128; }

// The rows of v8: the head dim rounded up to whole NO-column slices.
int v8_rows(int s, int no) { return (s + no - 1) / no * no; }

template <int KSTEPS, int NO, int NWG, int STAGES, int CTAS>
cudaError_t launch_wgmma(const void* q, const void* k, const int8_t* v8, const float* sv, void* o,
                         int b, int tq, int tk, int h, int s, float scale, int bkj,
                         cudaStream_t stream) {
  using C = Pv8Wgmma<KSTEPS, NO, NWG, STAGES, CTAS>;
  const int s_pad = v8_rows(s, NO);
  CUtensorMap qm, km, vm;
  cudaError_t err = hopper::make_tile_map(&qm, q, b, tq, h, s, C::BQ);
  if (err == cudaSuccess) err = hopper::make_tile_map(&km, k, b, tk, h, s, C::BK);
  if (err == cudaSuccess) err = hopper::make_s8_kmajor_map(&vm, v8, b * h, s_pad, v8_keys(tk), NO);
  if (err != cudaSuccess) return err;
  auto kernel = pv_int8_wgmma_kernel<KSTEPS, NO, NWG, STAGES, CTAS>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((tq + C::BQ - 1) / C::BQ, b * h, s_pad / NO);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, sv, static_cast<bf16*>(o), tq, tk, h,
                                                s, scale * 1.4426950408889634f, bkj);
  return cudaGetLastError();
}

// The models' head dims (U-Net 40, 80, 160; autoencoder 512): the v8
// pre-pass, then the main kernel.  v8 [B * H, v8_rows, v8_keys(tk)] and,
// after it, sv [B * H, nblk] in `scratch`.
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* scratch, void* o,
                           int b, int tq, int tk, int h, int s, float scale, int bkj,
                           const int* geo, cudaStream_t st) {
#define LDM_PV8(KSTEPS, NO, ...)                                                                \
  if (pv8_geometry_is<KSTEPS, NO, __VA_ARGS__>(geo, s)) {                                       \
    const int s_pad = v8_rows(s, NO), tk_pad = v8_keys(tk);                                     \
    int8_t* v8 = static_cast<int8_t*>(scratch);                                                 \
    float* svf = reinterpret_cast<float*>(v8 + (long)b * h * s_pad * tk_pad);                   \
    cudaError_t err = v_quant<bf16>(v, svf, v8, b, tk, h, s, bkj, s_pad, tk_pad, st);           \
    if (err != cudaSuccess) return err;                                                         \
    return launch_wgmma<KSTEPS, NO, __VA_ARGS__>(q, k, v8, svf, o, b, tq, tk, h, s, scale, bkj, \
                                                 st);                                           \
  }
  switch (s) {
    case 40: LDM_PV8(3, 48, 2, 2, 1); break;
    case 80: LDM_PV8(5, 80, 2, 2, 1); break;
    case 160: LDM_PV8(10, 160, 1, 2, 1); break;
    case 512: LDM_PV8(32, 128, 1, 2, 1); break;
  }
  return cudaErrorInvalidValue;
#undef LDM_PV8
}

// The wgmma path's operands: TMA needs 16-byte aligned bases and strides.
bool takes_wgmma(const void* q, const void* k, const void* v, const void* o, int s) {
  return s % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16
// operands, 0 for float32.  bkj: the JAX block, a multiple of 128.
// geometry: null, or the wgmma path's launch geometry (bf16 at the models'
// head dims; the caller's wgmma_geometry("pv8", s)).  scratch: with a
// geometry, v8 [B * H, S_pad, Tk_pad] int8 (S_pad = S rounded up to the
// geometry's column slices, Tk_pad = Tk rounded up to 128) and after it sv
// [B * H, ceil(tk / bkj)] float32; without one, sv alone.  *path receives the
// path taken: 0 FMA, 1 mma.sync, 2 wgmma.  The caller checks shapes (s <=
// 512, tk >= 1).
extern "C" int ldm_flash_attention_pv_int8_fwd(const void* q, const void* k, const void* v,
                                               void* o, void* scratch, int b, int tq, int tk,
                                               int h, int s, int bkj, float scale, int is_bf16,
                                               const int* geometry, int* path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && geometry != nullptr && takes_wgmma(q, k, v, o, s)) {
    *path = 2;
    return static_cast<int>(
        dispatch_wgmma(q, k, v, scratch, o, b, tq, tk, h, s, scale, bkj, geometry, st));
  }
  float* svf = static_cast<float*>(scratch);
  if (geometry != nullptr)  // sv after the (unused) v8 space
    svf = reinterpret_cast<float*>(static_cast<int8_t*>(scratch) +
                                   (long)b * h * v8_rows(s, geometry[2]) * v8_keys(tk));
  cudaError_t err = is_bf16 ? v_quant<bf16>(v, svf, nullptr, b, tk, h, s, bkj, 0, 0, st)
                            : v_quant<float>(v, svf, nullptr, b, tk, h, s, bkj, 0, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!is_bf16) {
    *path = 0;
    err = dispatch_fma<float>(q, k, v, svf, o, b, tq, tk, h, s, scale, bkj, st);
  } else if (takes_mma(q, k, v, o, s)) {
    *path = 1;
    err = dispatch_mma(q, k, v, svf, o, b, tq, tk, h, s, scale, bkj, st);
  } else {
    *path = 0;
    err = dispatch_fma<bf16>(q, k, v, svf, o, b, tq, tk, h, s, scale, bkj, st);
  }
  return static_cast<int>(err);
}
