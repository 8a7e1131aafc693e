// Flash-attention backward for Hopper (sm_90a), FlashAttention-2 style:
// given q, k, v, the output's gradient dO, the forward's per-row
// log-sum-exp lse and di = rowsum(dO * O),
//     p  = exp(scale * q k^T - lse)        (masked to 0 on padded keys)
//     dp = dO v^T,   ds = p * (dp - di)
//     dq = scale * ds k,   dk = scale * ds^T q,   dv = p^T dO
//
// Replaces the TPU kernels ldm_tf2_tpu/ops/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (reached there through _backward_packed and
// _backward_flat).  As there, two kernels and no atomics, so the result is
// deterministic:
//  * dq kernel: one thread block per (b*h, q-tile); a loop inside the block
//    walks the kv tiles and accumulates dq in float32.
//  * dk/dv kernel: one thread block per (b*h, kv-tile); a loop walks the
//    q tiles and accumulates dk and dv in float32.
// Each loop replaces the TPU grid's sequential axis, whose accumulators
// lived in VMEM scratch.  di is computed by the caller (the JAX package
// computes it in XLA, outside its kernels).
//
// Layout: q, dO, dq [B, Tq, H, S]; k, v, dk, dv [B, Tk, H, S], contiguous,
// read in place with token stride H*S (no head-major relayout, no 128-lane
// pad); lse, di [B, H, Tq] float32.  Outputs are written once, in the input
// type (float32 or bfloat16); accumulation is float32.
//
// Masking: padded key columns of the ragged kv tail get p = 0 before any
// product (the TPU kernels' masked=True): exp(0 - lse) can overflow for an
// extreme lse, and 0 * inf would poison real rows of dq.  Padded q rows
// are loaded as zeros with lse = di = 0, get p = 0 where they enter dk and
// dv, and are never stored.
//
// What bounds it on this card: 7 * 2 * Tq * Tk * S operations per (b, h)
// (s, dp and dq in one kernel; s, dp, dv and dk in the other) against
// about 8 * (Tq + Tk) * S bytes, so both kernels are compute-bound at the
// training path's level-0 shape (1024 tokens), where most of the work is;
// from 256 tokens down the bytes bound them.
//
// Paths, chosen in the C entry; the caller's counters read which one ran:
//
// wgmma path (bf16 at the models' head dims: the U-Net's 40, 80, 160 and
// the autoencoder's 512; the launch geometry comes from the wrapper's
// wgmma_geometry and must match an instantiation below), built from
// hopper.cuh's blocks like the forward's wgmma path.  A producer warp
// issues TMA loads of the CTA's resident pair (q and dO in the dq kernel,
// k and v in the dk/dv kernel) and streams the other pair through a ring of
// stages; consumer warpgroups of 64 resident rows compute both score
// products on wgmma (s and dp, operands K-major in shared memory), p and ds
// in registers, and the second products (ds k; p^T dO and ds^T q) with p
// and ds as register A operands in two bf16 terms each (hi + lo: see
// mma_xb), the streamed tile MN-major with the transpose flag.  TMA
// zero-fills columns past S and rows past T.  The dk/dv kernel reads each
// streamed q tile's lse and di from global memory (L1/L2) in the threads
// that use them.  S = 512: dq, dk and dv accumulators of 64 x 512 f32 would
// take 256 registers a thread each, so their columns are split over 4 CTAs
// (128 each), each recomputing s and dp over the whole head; 32-row
// streamed tiles in one stage keep the resident pair (128 KB) and a stage
// (64 KB) in shared memory.  S = 160 in dk/dv: one warpgroup of 64 keys and
// 32-query tiles (dk and dv accumulators of 80 registers each).
//
// mma.sync path (bf16 at other head dims, S <= 80, S % 8 == 0, 16-byte
// aligned operands): mma.sync m16n8k16 bf16 with f32 accumulation, the
// layout of the forward's mma.sync path.  4 warps each own 16 rows of the
// block's 64-row tile (queries in the dq kernel, keys in the dk/dv kernel),
// whose two operands (q and dO, or k and v) stay in registers as A
// fragments; the other side's 64-row tiles stream through two shared-memory
// stages by cp.async (zero-fill for ragged tails and the head-dim pad).
// Both score products (s and dp) share one pass over the streamed tile; p
// and ds are formed in the accumulators and re-packed as A fragments for
// the second products (ds k, or p^T dO and ds^T q), as the forward re-packs
// p, but as two bf16 terms each (hi + lo) to keep their float32 precision.
//
// FMA path (float32, and bf16 heads the other paths do not take): scalar
// FMAs through shared memory.  Rows of q, dO, k and v are stored with
// stride S+1 (odd), so the threads of a warp, each on its own key, read
// distinct banks, and the accumulation loops read consecutive addresses.
// Tiles: 32 x 32 for S <= 160 (at most 132 KB of shared memory), 16 x 16
// for larger S (199 KB at S = 512).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 128;

// Stage rows [t0, t0 + n) of one head of x ([B, T, H, S], token stride tok)
// into dst [n][s+1] as float32; rows at or past t_end are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int t0, int n, int t_end,
                                           int s, long tok, int tid) {
  const int sk = s + 1;
  for (int i = tid; i < n * s; i += kThreads) {
    const int r = i / s, c = i % s, t = t0 + r;
    dst[r * sk + c] = t < t_end ? to_f32(src[t * tok + c]) : 0.f;
  }
}

// The (BQ x BK) score tile shared by both kernels: every thread owns one key
// column `col` and RPT consecutive query rows from r0, and computes
//   p  = exp(scale * q k^T - lse)  (0 where the key or the row is padded)
//   ds = p * (dO v^T - di).
template <int BQ, int BK, int RPT>
__device__ __forceinline__ void score_tile(const float* qs, const float* dos, const float* ks,
                                           const float* vs, const float* lse_s,
                                           const float* di_s, int s, float scale, int col,
                                           int r0, bool key_ok, int rows_left, float (&p)[RPT],
                                           float (&ds)[RPT]) {
  const int sk = s + 1;
  float acc_s[RPT], acc_dp[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc_s[j] = acc_dp[j] = 0.f;
  const float* krow = ks + col * sk;
  const float* vrow = vs + col * sk;
  for (int c = 0; c < s; ++c) {
    const float kv = krow[c], vv = vrow[c];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      acc_s[j] = fmaf(qs[(r0 + j) * sk + c], kv, acc_s[j]);
      acc_dp[j] = fmaf(dos[(r0 + j) * sk + c], vv, acc_dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = r0 + j;
    const bool ok = key_ok && r < rows_left;
    p[j] = ok ? expf(acc_s[j] * scale - lse_s[r]) : 0.f;
    ds[j] = p[j] * (acc_dp[j] - di_s[r]);
  }
}

template <int BQ, int BK>
size_t dq_smem_bytes(int s) {
  return ((size_t)2 * BQ * (s + 1)     // q, dO [BQ][s+1]
          + (size_t)2 * BK * (s + 1)   // k, v [BK][s+1]
          + (size_t)BQ * (BK + 1)      // ds [BQ][BK+1]
          + (size_t)BQ * s             // dq accumulator [BQ][s]
          + 2 * BQ) * sizeof(float);   // lse, di
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int tq, int tk, int h,
                    int s, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int sk = s + 1;
  float* qs = smem;                   // [BQ][s+1]
  float* dos = qs + BQ * sk;          // [BQ][s+1]
  float* ks = dos + BQ * sk;          // [BK][s+1]
  float* vs = ks + BK * sk;           // [BK][s+1]
  float* dss = vs + BK * sk;          // [BQ][BK+1]
  float* acc = dss + BQ * (BK + 1);   // [BQ][s]
  float* lse_s = acc + BQ * s;
  float* di_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const long tok = (long)h * s;
  const long qoff = (long)b * tq * tok + (long)head * s;
  const long koff = (long)b * tk * tok + (long)head * s;
  const float* lb = lse + (long)blockIdx.y * tq;
  const float* db = di + (long)blockIdx.y * tq;

  stage_rows(qs, q + qoff, q0, BQ, tq, s, tok, tid);
  stage_rows(dos, dout + qoff, q0, BQ, tq, s, tok, tid);
  for (int i = tid; i < BQ * s; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < BQ; r += kThreads) {
    const bool ok = q0 + r < tq;
    lse_s[r] = ok ? lb[q0 + r] : 0.f;
    di_s[r] = ok ? db[q0 + r] : 0.f;
  }

  constexpr int kGroups = kThreads / BK;
  constexpr int RPT = BQ / kGroups;
  static_assert(kThreads % BK == 0 && BQ % kGroups == 0, "tile shape");
  const int col = tid % BK;
  const int r0 = (tid / BK) * RPT;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers of ks, vs and dss are done
    stage_rows(ks, k + koff, k0, BK, tk, s, tok, tid);
    stage_rows(vs, v + koff, k0, BK, tk, s, tok, tid);
    __syncthreads();

    float p[RPT], ds[RPT];
    score_tile<BQ, BK, RPT>(qs, dos, ks, vs, lse_s, di_s, s, scale, col, r0, k0 + col < tk,
                            tq - q0, p, ds);
#pragma unroll
    for (int j = 0; j < RPT; ++j) dss[(r0 + j) * (BK + 1) + col] = ds[j];
    __syncthreads();

    // dq += ds k: thread i owns (row, dim) pairs; consecutive threads read
    // consecutive dims of a k row and one ds row (a broadcast).
    for (int i = tid; i < BQ * s; i += kThreads) {
      const int r = i / s, c = i % s;
      const float* dsrow = dss + r * (BK + 1);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) sum = fmaf(dsrow[j], ks[j * sk + c], sum);
      acc[i] += sum;
    }
  }
  __syncthreads();
  T* dqb = dq + qoff;
  for (int i = tid; i < BQ * s; i += kThreads) {
    const int r = i / s, c = i % s, t = q0 + r;
    if (t < tq) dqb[t * tok + c] = from_f32<T>(acc[i] * scale);
  }
}

template <int BQ, int BK>
size_t dkv_smem_bytes(int s) {
  return ((size_t)2 * BQ * (s + 1)     // q, dO [BQ][s+1]
          + (size_t)2 * BK * (s + 1)   // k, v [BK][s+1]
          + (size_t)2 * BQ * (BK + 1)  // p, ds [BQ][BK+1]
          + (size_t)2 * BK * s         // dk, dv accumulators [BK][s]
          + 2 * BQ) * sizeof(float);   // lse, di
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int tq, int tk, int h, int s, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int sk = s + 1;
  float* qs = smem;                   // [BQ][s+1]
  float* dos = qs + BQ * sk;          // [BQ][s+1]
  float* ks = dos + BQ * sk;          // [BK][s+1]
  float* vs = ks + BK * sk;           // [BK][s+1]
  float* ps = vs + BK * sk;           // [BQ][BK+1]
  float* dss = ps + BQ * (BK + 1);    // [BQ][BK+1]
  float* dk_acc = dss + BQ * (BK + 1);  // [BK][s]
  float* dv_acc = dk_acc + BK * s;      // [BK][s]
  float* lse_s = dv_acc + BK * s;
  float* di_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int k0 = blockIdx.x * BK;
  const long tok = (long)h * s;
  const long qoff = (long)b * tq * tok + (long)head * s;
  const long koff = (long)b * tk * tok + (long)head * s;
  const float* lb = lse + (long)blockIdx.y * tq;
  const float* db = di + (long)blockIdx.y * tq;

  stage_rows(ks, k + koff, k0, BK, tk, s, tok, tid);
  stage_rows(vs, v + koff, k0, BK, tk, s, tok, tid);
  for (int i = tid; i < BK * s; i += kThreads) dk_acc[i] = dv_acc[i] = 0.f;

  constexpr int kGroups = kThreads / BK;
  constexpr int RPT = BQ / kGroups;
  static_assert(kThreads % BK == 0 && BQ % kGroups == 0, "tile shape");
  const int col = tid % BK;
  const int r0 = (tid / BK) * RPT;
  const bool key_ok = k0 + col < tk;

  for (int q0 = 0; q0 < tq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers of qs, dos, ps, dss are done
    stage_rows(qs, q + qoff, q0, BQ, tq, s, tok, tid);
    stage_rows(dos, dout + qoff, q0, BQ, tq, s, tok, tid);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool ok = q0 + r < tq;
      lse_s[r] = ok ? lb[q0 + r] : 0.f;
      di_s[r] = ok ? db[q0 + r] : 0.f;
    }
    __syncthreads();

    float p[RPT], ds[RPT];
    score_tile<BQ, BK, RPT>(qs, dos, ks, vs, lse_s, di_s, s, scale, col, r0, key_ok, tq - q0,
                            p, ds);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      ps[(r0 + j) * (BK + 1) + col] = p[j];
      dss[(r0 + j) * (BK + 1) + col] = ds[j];
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T q: thread i owns (key, dim) pairs.
    for (int i = tid; i < BK * s; i += kThreads) {
      const int c = i / s, d = i % s;
      float sv = 0.f, sk_ = 0.f;
      for (int r = 0; r < BQ; ++r) {
        sv = fmaf(ps[r * (BK + 1) + c], dos[r * sk + d], sv);
        sk_ = fmaf(dss[r * (BK + 1) + c], qs[r * sk + d], sk_);
      }
      dv_acc[i] += sv;
      dk_acc[i] += sk_;
    }
  }
  __syncthreads();
  T* dkb = dk + koff;
  T* dvb = dv + koff;
  for (int i = tid; i < BK * s; i += kThreads) {
    const int c = i / s, d = i % s, t = k0 + c;
    if (t < tk) {
      dkb[t * tok + d] = from_f32<T>(dk_acc[i] * scale);
      dvb[t * tok + d] = from_f32<T>(dv_acc[i]);
    }
  }
}

template <typename T, int BQ, int BK>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, void* dq, int b, int tq, int tk, int h,
                      int s, float scale, cudaStream_t stream) {
  const size_t bytes = dq_smem_bytes<BQ, BK>(s);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BQ - 1) / BQ, b * h);
  flash_bwd_dq_kernel<T, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), tq, tk, h, s, scale);
  return cudaGetLastError();
}

template <typename T, int BQ, int BK>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, void* dk, void* dv, int b, int tq,
                       int tk, int h, int s, float scale, cudaStream_t stream) {
  const size_t bytes = dkv_smem_bytes<BQ, BK>(s);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + BK - 1) / BK, b * h);
  flash_bwd_dkv_kernel<T, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, h,
      s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* di, void* dq, int b, int tq, int tk,
                        int h, int s, float scale, cudaStream_t st) {
  if (s <= 160) return launch_dq<T, 32, 32>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
  return launch_dq<T, 16, 16>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* di, void* dk, void* dv, int b, int tq,
                         int tk, int h, int s, float scale, cudaStream_t st) {
  if (s <= 160)
    return launch_dkv<T, 32, 32>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
  return launch_dkv<T, 16, 16>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
}

// ------------------------------------------------------ tensor-core path

constexpr int kMmaRows = 64;  // rows of every tile: 4 warps x 16
constexpr float kLog2e = 1.4426950408889634f;

// The block's own tile (two operands) and two stages of the streamed tile
// (two operands), each [64][SP+8] bf16, then two stages of lse and di rows
// (the dk/dv kernel's; the dq kernel leaves them unused).
template <int SP>
constexpr size_t mma_smem_bytes() {
  return (size_t)6 * kMmaRows * (SP + 8) * sizeof(bf16) + 4 * kMmaRows * sizeof(float);
}

// cp.async rows [t0, t0 + 64) of one head of x ([B, T, H, S], token stride
// tok) into dst [64][SP+8]; rows at or past t_end and dims past s are zeros.
template <int SP>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int t0, int t_end,
                                                int s, long tok, int tid) {
  constexpr int LD = SP + 8, CH = SP / 8;
  for (int i = tid; i < kMmaRows * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8, t = t0 + r;
    const bool ok = t < t_end && c < s;
    cp_async16(dst + r * LD + c, src + (ok ? (long)t * tok + c : 0), ok);
  }
}

// a (this warp's 16 rows x SP, A fragments) times the 64-row tile b [64][LD]
// transposed, into acc[8][4]: acc n-tile j holds columns 8j..8j+7.
template <int SP>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[SP / 16][4],
                                        const bf16* b, int lane) {
  constexpr int LD = SP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(acc[2 * np], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// (x0, x1) ~ hi + lo, each a packed bf16 pair: 16 of float32's 24 mantissa
// bits.
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// acc[SP/8][4] += x (this warp's 16 rows x 64, held as f32 accumulators in
// the layout mma_abt leaves) times the 64-row tile b [64][LD].  x enters as
// two bf16 terms, hi + lo, so the product keeps the JAX kernels' float32 p
// and ds: one bf16 term loses ds's zero sum over a row, which keys far from
// zero mean turn into a dq error of 8e-3 rel-L2 (the ragged extreme-logit
// check) against 2.4e-3 elsewhere.
template <int SP>
__device__ __forceinline__ void mma_xb(float (&acc)[SP / 8][4], const float (&x)[8][4],
                                       const bf16* b, int lane) {
  constexpr int LD = SP + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    pack_split(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    pack_split(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    pack_split(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    pack_split(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < SP / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                            (lane / 16) * 8);
      mma_bf16(acc[2 * dp], hi, bf[0], bf[1]);
      mma_bf16(acc[2 * dp], lo, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[2 * dp + 1], lo, bf[2], bf[3]);
    }
  }
}

// Rows warp*16 .. +15 of a [64][LD] tile as A fragments.
template <int SP>
__device__ __forceinline__ void load_a(uint32_t (&a)[SP / 16][4], const bf16* x, int warp,
                                       int lane) {
  constexpr int LD = SP + 8;
#pragma unroll
  for (int kk = 0; kk < SP / 16; ++kk)
    ldsm_x4(a[kk], x + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// Store acc * mul (this warp's 16 rows, dims < s) to rows row0.. of one
// head of y ([T, H, S] from y, token stride tok); rows at or past t_end are
// not stored.
template <int SP>
__device__ __forceinline__ void store_rows(bf16* y, const float (&acc)[SP / 8][4], float mul,
                                           int row0, int t_end, int s, long tok, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int n = 0; n < SP / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c >= s) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + g + 8 * r;
      if (t < t_end)
        *reinterpret_cast<__nv_bfloat162*>(y + (long)t * tok + c) =
            __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

// One block per (b*h, 64 queries); the loop streams 64-key tiles of k, v.
// Element e of accumulator n-tile j is query row warp*16 + g + 8*(e/2) and
// key 8j + 2*t4 + (e&1) of the tile.
template <int SP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dq, int tq, int tk, int h, int s, float scale) {
  constexpr int LD = SP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kMmaRows * LD;
  bf16* kvs = dos + kMmaRows * LD;  // stage i: k at kvs + 2i*64*LD, v after it

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kMmaRows;
  const long tok = (long)h * s;
  const long qoff = (long)b * tq * tok + (long)head * s;
  const long koff = (long)b * tk * tok + (long)head * s;

  load_tile_async<SP>(qs, q + qoff, q0, tq, s, tok, tid);
  load_tile_async<SP>(dos, dout + qoff, q0, tq, s, tok, tid);
  auto load_kv = [&](int tile) {
    bf16* ksm = kvs + (tile & 1) * 2 * kMmaRows * LD;
    load_tile_async<SP>(ksm, k + koff, tile * kMmaRows, tk, s, tok, tid);
    load_tile_async<SP>(ksm + kMmaRows * LD, v + koff, tile * kMmaRows, tk, s, tok, tid);
  };
  load_kv(0);
  cp_async_commit();

  // this thread's rows g and g+8: lse in log2 units, and di
  float lse2[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    const bool ok = t < tq;
    lse2[r] = ok ? lse[(long)blockIdx.y * tq + t] * kLog2e : 0.f;
    di_r[r] = ok ? di[(long)blockIdx.y * tq + t] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  uint32_t qf[SP / 16][4], dof[SP / 16][4];
  float acc[SP / 8][4];
#pragma unroll
  for (int n = 0; n < SP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (tk + kMmaRows - 1) / kMmaRows;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_a<SP>(qf, qs, warp, lane);
      load_a<SP>(dof, dos, warp, lane);
    }
    const bf16* ksm = kvs + (it & 1) * 2 * kMmaRows * LD;
    const bf16* vsm = ksm + kMmaRows * LD;

    float sacc[8][4], dpacc[8][4];
    mma_abt<SP>(sacc, qf, ksm, lane);   // q k^T
    mma_abt<SP>(dpacc, dof, vsm, lane);  // dO v^T
    const int key0 = it * kMmaRows + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + (e & 1) < tk;
        const float p = ok ? exp2f(sacc[j][e] * scale_log2 - lse2[e / 2]) : 0.f;
        sacc[j][e] = p * (dpacc[j][e] - di_r[e / 2]);  // ds
      }
    mma_xb<SP>(acc, sacc, ksm, lane);  // dq += ds k
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  store_rows<SP>(dq + qoff, acc, scale, q0 + warp * 16, tq, s, tok, lane);
}

// One block per (b*h, 64 keys); the loop streams 64-query tiles of q, dO
// with their lse and di.  Element e of accumulator n-tile j is key row
// warp*16 + g + 8*(e/2) and query 8j + 2*t4 + (e&1) of the tile.
template <int SP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int h,
                         int s, float scale) {
  constexpr int LD = SP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kMmaRows * LD;
  bf16* qdo = vs + kMmaRows * LD;  // stage i: q at qdo + 2i*64*LD, dO after it
  float* rows = reinterpret_cast<float*>(qdo + 4 * kMmaRows * LD);  // stage i: lse2, di

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int k0 = blockIdx.x * kMmaRows;
  const long tok = (long)h * s;
  const long qoff = (long)b * tq * tok + (long)head * s;
  const long koff = (long)b * tk * tok + (long)head * s;
  const float* lb = lse + (long)blockIdx.y * tq;
  const float* db = di + (long)blockIdx.y * tq;

  load_tile_async<SP>(ks, k + koff, k0, tk, s, tok, tid);
  load_tile_async<SP>(vs, v + koff, k0, tk, s, tok, tid);
  auto load_q = [&](int tile) {
    bf16* qsm = qdo + (tile & 1) * 2 * kMmaRows * LD;
    load_tile_async<SP>(qsm, q + qoff, tile * kMmaRows, tq, s, tok, tid);
    load_tile_async<SP>(qsm + kMmaRows * LD, dout + qoff, tile * kMmaRows, tq, s, tok, tid);
    float* lr = rows + (tile & 1) * 2 * kMmaRows;
    for (int r = tid; r < kMmaRows; r += kThreads) {
      const int t = tile * kMmaRows + r;
      const bool ok = t < tq;
      lr[r] = ok ? lb[t] * kLog2e : 0.f;
      lr[kMmaRows + r] = ok ? db[t] : 0.f;
    }
  };
  load_q(0);
  cp_async_commit();

  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + g + 8 * r < tk;
  const float scale_log2 = scale * kLog2e;

  uint32_t kf[SP / 16][4], vf[SP / 16][4];
  float dk_acc[SP / 8][4], dv_acc[SP / 8][4];
#pragma unroll
  for (int n = 0; n < SP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int ntiles = (tq + kMmaRows - 1) / kMmaRows;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_a<SP>(kf, ks, warp, lane);
      load_a<SP>(vf, vs, warp, lane);
    }
    const bf16* qsm = qdo + (it & 1) * 2 * kMmaRows * LD;
    const bf16* dosm = qsm + kMmaRows * LD;
    const float* lse2 = rows + (it & 1) * 2 * kMmaRows;
    const float* di_s = lse2 + kMmaRows;

    float pacc[8][4], dsacc[8][4];
    mma_abt<SP>(pacc, kf, qsm, lane);    // k q^T
    mma_abt<SP>(dsacc, vf, dosm, lane);  // v dO^T
    const int qrow0 = it * kMmaRows;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const bool ok = key_ok[e / 2] && qrow0 + c < tq;
        const float p = ok ? exp2f(pacc[j][e] * scale_log2 - lse2[c]) : 0.f;
        dsacc[j][e] = p * (dsacc[j][e] - di_s[c]);  // ds^T
        pacc[j][e] = p;                               // p^T
      }
    mma_xb<SP>(dv_acc, pacc, dosm, lane);  // dv += p^T dO
    mma_xb<SP>(dk_acc, dsacc, qsm, lane);  // dk += ds^T q
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  store_rows<SP>(dk + koff, dk_acc, scale, k0 + warp * 16, tk, s, tok, lane);
  store_rows<SP>(dv + koff, dv_acc, 1.f, k0 + warp * 16, tk, s, tok, lane);
}

template <int SP>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, void* dq, int b, int tq, int tk,
                          int h, int s, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<SP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<SP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kMmaRows - 1) / kMmaRows, b * h);
  flash_bwd_dq_mma_kernel<SP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq), tq, tk, h, s, scale);
  return cudaGetLastError();
}

template <int SP>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, void* dk, void* dv, int b, int tq,
                           int tk, int h, int s, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<SP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<SP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + kMmaRows - 1) / kMmaRows, b * h);
  flash_bwd_dkv_mma_kernel<SP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      tq, tk, h, s, scale);
  return cudaGetLastError();
}

// The tensor-core path's head dims: S % 8 == 0 (16-byte rows), S <= 80.
bool takes_mma(std::initializer_list<const void*> ptrs, int s) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return s % 8 == 0 && s <= 80;
}

// The wgmma path's operands: TMA needs 16-byte aligned bases and strides.
bool takes_wgmma(std::initializer_list<const void*> ptrs, int s) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return s % 8 == 0;
}

cudaError_t dispatch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* di, void* dq, int b, int tq, int tk,
                            int h, int s, float scale, cudaStream_t st) {
  switch ((s + 15) / 16) {
    case 1: return launch_dq_mma<16>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
    case 2: return launch_dq_mma<32>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
    case 3: return launch_dq_mma<48>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
    case 4: return launch_dq_mma<64>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
    default: return launch_dq_mma<80>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
  }
}

cudaError_t dispatch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* di, void* dk, void* dv, int b,
                             int tq, int tk, int h, int s, float scale, cudaStream_t st) {
  switch ((s + 15) / 16) {
    case 1: return launch_dkv_mma<16>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
    case 2: return launch_dkv_mma<32>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
    case 3: return launch_dkv_mma<48>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
    case 4: return launch_dkv_mma<64>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
    default: return launch_dkv_mma<80>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
  }
}

// ------------------------------------------------------------ wgmma path

// Shared by both kernels: KSTEPS k-steps of 16 head-dim columns in the score
// products (s and dp); NO output columns per CTA (blockIdx.z selects the
// slice); NWG consumer warpgroups of 64 resident rows each (queries in the
// dq kernel, keys in the dk/dv kernel); TILE rows per streamed tile (keys,
// or queries); STAGES streamed stages.  The resident tile pair (q and dO,
// or k and v) and every streamed pair are loaded whole, all KCH chunks,
// since the score products contract over the whole head dim.
template <int KSTEPS, int NO, int TILE, int NWG, int STAGES, int CTAS>
struct BwdWgmma {
  static constexpr int ROWS = 64 * NWG;
  static constexpr int TILE_ROWS = TILE;
  static constexpr int NSTAGES = STAGES;
  static constexpr int KCH = (KSTEPS * 16 + 63) / 64;
  static constexpr int RES_BYTES = KCH * ROWS * 128;  // each of the two resident tiles
  static constexpr int TILE_BYTES = KCH * TILE * 128;  // each of the two streamed tiles
  static constexpr int THREADS = NWG * 128 + 32;        // + one producer warp
  static constexpr int SMEM = 1024 + 2 * RES_BYTES + STAGES * 2 * TILE_BYTES + 64;
  static_assert(1 + 2 * STAGES <= 8, "barrier space");
  // a slice after the first starts at a 64-column chunk
  static_assert(NO % 64 == 0 || NO + 15 >= KSTEPS * 16, "column slice");
};

// The producer warp's loop, the same in both kernels: the resident pair
// (ra from map ma, rb from map mb, rows [r_t0, r_t0 + ROWS)) into `res`,
// then every streamed pair (maps sa, sb, rows [j * TILE, ..)) into the ring.
template <typename C>
__device__ __forceinline__ void bwd_produce(unsigned char* res, unsigned char* ring,
                                            uint64_t* res_full, uint64_t* full, uint64_t* empty,
                                            const CUtensorMap* ma, const CUtensorMap* mb,
                                            const CUtensorMap* sa, const CUtensorMap* sb,
                                            int r_t0, int ntiles, int head, int b) {
  using namespace hopper;
  mbar_expect_tx(res_full, 2 * C::RES_BYTES);
  tma_load_tile(res, ma, res_full, 0, C::KCH, C::ROWS, head, r_t0, b);
  tma_load_tile(res + C::RES_BYTES, mb, res_full, 0, C::KCH, C::ROWS, head, r_t0, b);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % C::NSTAGES, t0 = j * C::TILE_ROWS;
    mbar_wait(&empty[st], ((j / C::NSTAGES) & 1) ^ 1);
    unsigned char* dst = ring + st * 2 * C::TILE_BYTES;
    mbar_expect_tx(&full[st], 2 * C::TILE_BYTES);
    tma_load_tile(dst, sa, &full[st], 0, C::KCH, C::TILE_ROWS, head, t0, b);
    tma_load_tile(dst + C::TILE_BYTES, sb, &full[st], 0, C::KCH, C::TILE_ROWS, head, t0, b);
  }
}

// x (this warpgroup's 64 rows x 16*NK, f32 accumulator layout) as the A
// operands of NK k-steps, each in two bf16 terms, hi + lo (see mma_xb).
// Split before the products are issued: a register written between two
// wgmma issues serializes them.
template <int NK>
__device__ __forceinline__ void split_frags(const float (&x)[NK * 8], uint32_t (&hi)[NK][4],
                                            uint32_t (&lo)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pack_split(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// acc (this warpgroup's 64 rows x NO) += (hi + lo) times NK k-steps of the
// MN-major tile b (TILE rows, from chunk `chunk`).
template <int NO, int NK, int TILE>
__device__ __forceinline__ void wgmma_xb(float (&acc)[NO / 2], const uint32_t (&hi)[NK][4],
                                         const uint32_t (&lo)[NK][4], uint32_t b, int chunk) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t db = desc_mnmajor(b, TILE, chunk, kk);
    WgmmaRS<NO>::run(acc, hi[kk], db, 1);
    WgmmaRS<NO>::run(acc, lo[kk], db, 1);
  }
}

// Store acc * mul (this thread's rows row0 + g, + 8; columns n0 + 8n + 2t4
// below s) to y ([T, H, S] of one batch and head, token stride tok); rows at
// or past t_end are not stored.
template <int NO>
__device__ __forceinline__ void store_slice(bf16* y, const float (&acc)[NO / 2], float mul,
                                            int row0, int t_end, int n0, int s, long tok,
                                            int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int n = 0; n < NO / 8; ++n) {
    const int c = n0 + n * 8 + 2 * t4;
    if (c >= s) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + g + 8 * r;
      if (t < t_end)
        *reinterpret_cast<__nv_bfloat162*>(y + (long)t * tok + c) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

// dq: CTA = (64*NWG queries, one slice of NO columns); resident q and dO,
// streamed k and v tiles of TILE keys.
template <int KSTEPS, int NO, int TILE, int NWG, int STAGES, int CTAS>
__global__ void __launch_bounds__(NWG * 128 + 32, CTAS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          bf16* __restrict__ dq, int tq, int tk, int h, int s, float scale) {
  using C = BwdWgmma<KSTEPS, NO, TILE, NWG, STAGES, CTAS>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = res + 2 * C::RES_BYTES;  // stage i: k, then v
  uint64_t* res_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * C::TILE_BYTES);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * C::ROWS;
  const int n0 = blockIdx.z * NO;
  const int ntiles = (tk + TILE - 1) / TILE;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == NWG * 4) {
    if (lane == 0)
      bwd_produce<C>(res, ring, res_full, full, empty, &qmap, &domap, &kmap, &vmap, q0, ntiles,
                     head, b);
    return;
  }

  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16;
  float lse2[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + g + 8 * r;
    const bool ok = t < tq;
    lse2[r] = ok ? lse[(long)blockIdx.y * tq + t] * kLog2e : 0.f;
    di_r[r] = ok ? di[(long)blockIdx.y * tq + t] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const uint32_t qs_a = smem_u32(res), dos_a = qs_a + C::RES_BYTES;
  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  mbar_wait(res_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t ks_a = smem_u32(ring + st * 2 * C::TILE_BYTES);
    const uint32_t vs_a = ks_a + C::TILE_BYTES;
    float sacc[TILE / 2], dpacc[TILE / 2];
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // q k^T
      WgmmaSS<TILE>::run(sacc, desc_kmajor(qs_a, C::ROWS, wg * 64, kk),
                         desc_kmajor(ks_a, TILE, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // dO v^T
      WgmmaSS<TILE>::run(dpacc, desc_kmajor(dos_a, C::ROWS, wg * 64, kk),
                         desc_kmajor(vs_a, TILE, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);
    const int key0 = j * TILE + 2 * t4;
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int r = (i % 4) / 2;
      const bool ok = key0 + (i / 4) * 8 + (i & 1) < tk;
      const float p = ok ? ex2(fmaf(sacc[i], scale_log2, -lse2[r])) : 0.f;
      sacc[i] = p * (dpacc[i] - di_r[r]);  // ds
    }
    uint32_t hi[TILE / 16][4], lo[TILE / 16][4];
    split_frags<TILE / 16>(sacc, hi, lo);
    fence_regs(acc);
    wgmma_fence();
    wgmma_xb<NO, TILE / 16, TILE>(acc, hi, lo, ks_a, n0 / 64);  // dq += ds k
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }
  const long tok = (long)h * s;
  store_slice<NO>(dq + (long)b * tq * tok + (long)head * s, acc, scale, r0, tq, n0, s, tok, lane);
}

// dk/dv: CTA = (64*NWG keys, one slice of NO columns); resident k and v,
// streamed q and dO tiles of TILE queries with their lse and di (read from
// global memory by the threads that use them).
template <int KSTEPS, int NO, int TILE, int NWG, int STAGES, int CTAS>
__global__ void __launch_bounds__(NWG * 128 + 32, CTAS)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int h,
                           int s, float scale) {
  using C = BwdWgmma<KSTEPS, NO, TILE, NWG, STAGES, CTAS>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* res = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = res + 2 * C::RES_BYTES;  // stage i: q, then dO
  uint64_t* res_full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * C::TILE_BYTES);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int k0 = blockIdx.x * C::ROWS;
  const int n0 = blockIdx.z * NO;
  const int ntiles = (tq + TILE - 1) / TILE;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == NWG * 4) {
    if (lane == 0)
      bwd_produce<C>(res, ring, res_full, full, empty, &kmap, &vmap, &qmap, &domap, k0, ntiles,
                     head, b);
    return;
  }

  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r0 = k0 + wg * 64 + (warp % 4) * 16;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = r0 + g + 8 * r < tk;
  const float scale_log2 = scale * kLog2e;
  const float* lb = lse + (long)blockIdx.y * tq;
  const float* db = di + (long)blockIdx.y * tq;
  const uint32_t ks_a = smem_u32(res), vs_a = ks_a + C::RES_BYTES;
  float dk_acc[NO / 2], dv_acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(res_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    // this thread's query columns j*TILE + 8n + 2t4 + e: lse (log2 units)
    // and di, 0 past tq
    float lse_c[TILE / 8][2], di_c[TILE / 8][2];
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = j * TILE + 8 * n + 2 * t4 + e;
        lse_c[n][e] = t < tq ? lb[t] * kLog2e : 0.f;
        di_c[n][e] = t < tq ? db[t] : 0.f;
      }
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t qs_a = smem_u32(ring + st * 2 * C::TILE_BYTES);
    const uint32_t dos_a = qs_a + C::TILE_BYTES;
    float pacc[TILE / 2], dsacc[TILE / 2];
    fence_regs(pacc);
    fence_regs(dsacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // k q^T
      WgmmaSS<TILE>::run(pacc, desc_kmajor(ks_a, C::ROWS, wg * 64, kk),
                         desc_kmajor(qs_a, TILE, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)  // v dO^T
      WgmmaSS<TILE>::run(dsacc, desc_kmajor(vs_a, C::ROWS, wg * 64, kk),
                         desc_kmajor(dos_a, TILE, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pacc);
    fence_regs(dsacc);
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int n = i / 4, e = i & 1;
      const bool ok = key_ok[(i % 4) / 2] && j * TILE + 8 * n + 2 * t4 + e < tq;
      const float p = ok ? ex2(fmaf(pacc[i], scale_log2, -lse_c[n][e])) : 0.f;
      dsacc[i] = p * (dsacc[i] - di_c[n][e]);  // ds^T
      pacc[i] = p;                             // p^T
    }
    uint32_t p_hi[TILE / 16][4], p_lo[TILE / 16][4], ds_hi[TILE / 16][4], ds_lo[TILE / 16][4];
    split_frags<TILE / 16>(pacc, p_hi, p_lo);
    split_frags<TILE / 16>(dsacc, ds_hi, ds_lo);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
    wgmma_xb<NO, TILE / 16, TILE>(dv_acc, p_hi, p_lo, dos_a, n0 / 64);    // dv += p^T dO
    wgmma_xb<NO, TILE / 16, TILE>(dk_acc, ds_hi, ds_lo, qs_a, n0 / 64);  // dk += ds^T q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(&empty[st]);
  }
  const long tok = (long)h * s;
  const long koff = (long)b * tk * tok + (long)head * s;
  store_slice<NO>(dk + koff, dk_acc, scale, r0, tk, n0, s, tok, lane);
  store_slice<NO>(dv + koff, dv_acc, 1.f, r0, tk, n0, s, tok, lane);
}

// geometry: {resident rows per CTA, streamed tile rows, output columns per
// CTA, stages, dynamic shared bytes}, from ops/flash_attention.py's
// wgmma_geometry; a geometry this build does not hold is refused.
template <typename C, int TILE, int NO, int STAGES, int CTAS>
bool geometry_is(const int* geo, int s, int ksteps) {
  return geo[0] == C::ROWS && geo[1] == TILE && geo[2] == NO && geo[3] == STAGES &&
         geo[4] == C::SMEM && geo[5] == CTAS && ksteps == (s + 15) / 16;
}

// The four maps: q and dO in boxes of q_rows tokens, k and v in k_rows.
inline cudaError_t bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                            const void* dout, int b, int tq, int tk, int h, int s, int q_rows,
                            int k_rows) {
  cudaError_t err = hopper::make_tile_map(&m[0], q, b, tq, h, s, q_rows);
  if (err == cudaSuccess) err = hopper::make_tile_map(&m[1], k, b, tk, h, s, k_rows);
  if (err == cudaSuccess) err = hopper::make_tile_map(&m[2], v, b, tk, h, s, k_rows);
  if (err == cudaSuccess) err = hopper::make_tile_map(&m[3], dout, b, tq, h, s, q_rows);
  return err;
}

template <int KSTEPS, int NO, int TILE, int NWG, int STAGES, int CTAS>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* di, void* dq, int b, int tq, int tk,
                            int h, int s, float scale, cudaStream_t stream) {
  using C = BwdWgmma<KSTEPS, NO, TILE, NWG, STAGES, CTAS>;
  CUtensorMap m[4];
  cudaError_t err = bwd_maps(m, q, k, v, dout, b, tq, tk, h, s, C::ROWS, TILE);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<KSTEPS, NO, TILE, NWG, STAGES, CTAS>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((tq + C::ROWS - 1) / C::ROWS, b * h, (s + NO - 1) / NO);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], lse, di,
                                                static_cast<bf16*>(dq), tq, tk, h, s, scale);
  return cudaGetLastError();
}

template <int KSTEPS, int NO, int TILE, int NWG, int STAGES, int CTAS>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* di, void* dk, void* dv, int b, int tq,
                             int tk, int h, int s, float scale, cudaStream_t stream) {
  using C = BwdWgmma<KSTEPS, NO, TILE, NWG, STAGES, CTAS>;
  CUtensorMap m[4];
  cudaError_t err = bwd_maps(m, q, k, v, dout, b, tq, tk, h, s, TILE, C::ROWS);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_wgmma_kernel<KSTEPS, NO, TILE, NWG, STAGES, CTAS>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((tk + C::ROWS - 1) / C::ROWS, b * h, (s + NO - 1) / NO);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], lse, di,
                                                static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                tq, tk, h, s, scale);
  return cudaGetLastError();
}

// The models' head dims (U-Net 40, 80, 160; autoencoder 512).
cudaError_t dispatch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* di, void* dq, int b, int tq, int tk,
                              int h, int s, float scale, const int* geo, cudaStream_t st) {
#define LDM_DQ(KS, NO, TILE, NWG, ST, CTAS)                                                   \
  if (geometry_is<BwdWgmma<KS, NO, TILE, NWG, ST, CTAS>, TILE, NO, ST, CTAS>(geo, s, KS))        \
    return launch_dq_wgmma<KS, NO, TILE, NWG, ST, CTAS>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, \
                                                        scale, st)
  switch (s) {
    case 40: LDM_DQ(3, 40, 64, 2, 2, 1); break;
    case 80: LDM_DQ(5, 80, 64, 2, 2, 1); break;
    case 160: LDM_DQ(10, 160, 64, 1, 2, 1); break;
    case 512: LDM_DQ(32, 128, 32, 1, 1, 1); break;
  }
  return cudaErrorInvalidValue;
#undef LDM_DQ
}

cudaError_t dispatch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* di, void* dk, void* dv, int b,
                               int tq, int tk, int h, int s, float scale, const int* geo,
                               cudaStream_t st) {
#define LDM_DKV(KS, NO, TILE, NWG, ST, CTAS)                                                 \
  if (geometry_is<BwdWgmma<KS, NO, TILE, NWG, ST, CTAS>, TILE, NO, ST, CTAS>(geo, s, KS))        \
    return launch_dkv_wgmma<KS, NO, TILE, NWG, ST, CTAS>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, \
                                                         h, s, scale, st)
  switch (s) {
    case 40: LDM_DKV(3, 40, 64, 2, 2, 1); break;
    case 80: LDM_DKV(5, 80, 64, 2, 2, 1); break;
    case 160: LDM_DKV(10, 160, 32, 1, 2, 1); break;
    case 512: LDM_DKV(32, 128, 32, 1, 1, 1); break;
  }
  return cudaErrorInvalidValue;
#undef LDM_DKV
}

}  // namespace

// Both return a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16
// operands and outputs, 0 for float32.  geometry: null, or the wgmma path's
// launch geometry (bf16 at the models' head dims; the caller's
// wgmma_geometry).  *path receives the path taken: 0 FMA, 1 mma.sync,
// 2 wgmma.  The caller checks shapes (s <= 512, tk >= 1) and computes di.
extern "C" int ldm_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse, const float* di,
                                          void* dq, int b, int tq, int tk, int h, int s,
                                          float scale, int is_bf16, const int* geometry,
                                          int* path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && geometry != nullptr && takes_wgmma({q, k, v, dout, dq}, s)) {
    *path = 2;
    err = dispatch_dq_wgmma(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, geometry, st);
  } else if (is_bf16 && takes_mma({q, k, v, dout, dq}, s)) {
    *path = 1;
    err = dispatch_dq_mma(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
  } else {
    *path = 0;
    err = is_bf16 ? dispatch_dq<bf16>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st)
                  : dispatch_dq<float>(q, k, v, dout, lse, di, dq, b, tq, tk, h, s, scale, st);
  }
  return static_cast<int>(err);
}

extern "C" int ldm_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse, const float* di,
                                           void* dk, void* dv, int b, int tq, int tk, int h,
                                           int s, float scale, int is_bf16, const int* geometry,
                                           int* path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && geometry != nullptr && takes_wgmma({q, k, v, dout, dk, dv}, s)) {
    *path = 2;
    err = dispatch_dkv_wgmma(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, geometry,
                             st);
  } else if (is_bf16 && takes_mma({q, k, v, dout, dk, dv}, s)) {
    *path = 1;
    err = dispatch_dkv_mma(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
  } else {
    *path = 0;
    err = is_bf16
              ? dispatch_dkv<bf16>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st)
              : dispatch_dkv<float>(q, k, v, dout, lse, di, dk, dv, b, tq, tk, h, s, scale, st);
  }
  return static_cast<int>(err);
}
