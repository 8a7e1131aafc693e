// Flash-attention forward for Hopper (sm_90a): softmax(scale * Q K^T) V.
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/flash_attention.py::_flash_kernel
// (reached there through flash_attention / flash_attention_flat).
//
// Layout: q, o [B, Tq, H, S]; k, v [B, Tk, H, S], all contiguous, read in
// place with token stride H*S (no head-major relayout, no 128-lane pad).
//
// What bounds it on this card: at the main path's shapes attention is
// compute-bound (4*Tq*Tk*S operations against 2*(Tq+Tk)*S elements moved),
// so the two products have to run on the tensor cores.
//
// Common design (all three paths):
//  * one thread block per (b*h, q-tile); a loop inside the block walks the kv
//    tiles.  That loop replaces the TPU grid's sequential kv axis, whose
//    (acc, m, l) state lived in VMEM scratch.
//  * online softmax in f32 with f32 m, l and accumulator; the output is
//    written once, in the input type.
//  * the ragged kv tail is masked to -inf (the TPU kernel's masked=True);
//    the ragged q tail is loaded as zeros and never stored.
//  * the head dim is not padded to 128 lanes.
//
// Paths, chosen in the C entry; the caller's counter reads which one ran:
//
// wgmma path (bf16 at the models' head dims: the U-Net's 40, 80, 160 and
// the autoencoder's 512; the launch geometry comes from the wrapper's
// wgmma_geometry and must match an instantiation below).  Built from
// hopper.cuh's blocks:
//  * a producer warp issues TMA loads (4-D maps over [B, T, H, S]) of the
//    CTA's Q tile once and of K and V tiles into a ring of stages signalled
//    by mbarriers; consumer warpgroups of 64 query rows release a stage
//    after their P V.  TMA zero-fills the columns past S (40 -> a 64-column
//    chunk, of which Q K^T reads 48) and the rows past T, so no other
//    head's values and no ragged tail enter a product.
//  * S = Q K^T on wgmma m64nBKk16 (both operands K-major in shared memory),
//    the online softmax in registers, P rounded to bf16 and re-packed from
//    the accumulator into the register A operand of O += P V (m64nNOk16, V
//    MN-major with the transpose flag).
//  * S = 512: a 64 x 512 f32 accumulator would take 256 registers a
//    thread, and 64-row tiles give only 32-48 blocks for 132 SMs at the
//    autoencoder's [2|3, 1024, 1, 512].  So the output's columns are split
//    over 4 CTAs (blockIdx.z, 128 columns each), each computing all of Q K^T
//    (1.5x the work of one CTA, 2.5x in all) for 4x the blocks; the column-0
//    CTA writes lse.  Q (64 KB) stays resident; two stages of a 64-key K
//    tile (64 KB) and the CTA's V slice (16 KB): 225 KB of shared memory.
//  * S = 40 keeps two 8-warp CTAs on each SM (128 query rows, 64-key
//    tiles, at most 113 registers a thread) for latency hiding.
//  * What bounds it: operations at S = 512 (4*Tq*Tk*S against 2*(Tq+Tk)*S
//    elements); at S = 40 the 2^x of every score on the special-function
//    unit costs as much as the products (a score takes 1 exp against
//    4*40 tensor-core operations).
//
// mma.sync path (bf16 at other head dims, S <= 160, S % 8 == 0, 16-byte
// aligned operands): mma.sync m16n8k16 bf16 with f32 accumulation,
// FlashAttention-2 style.  4 warps each own 16 query rows of a 64-row
// tile; Q fragments stay in registers, S = Q K^T (16 x 64 per warp) and the
// output accumulator (16 x S) live in registers, and P is re-packed from the
// S accumulator layout straight into bf16 A fragments of P V.  K and V
// tiles of 64 keys are double-buffered in shared memory with cp.async
// (zero-fill for the ragged tail and the head-dim pad, S rounded up to 16);
// row strides of S+8 elements keep ldmatrix free of bank conflicts.  P is
// rounded to bf16 before P V, as the plain version's bf16 probabilities are.
//
// FMA path (float32 inputs, and bf16 heads the other paths do not take):
// scalar FMAs through shared memory.  K rows are stored with stride S+1
// (odd) so the threads of a warp, each on its own key, read distinct banks;
// S <= 160 uses 64x64 tiles (at most 182 KB of shared memory), larger S
// 16x32 tiles (199 KB).  Its float32 arithmetic keeps float32 results to
// summation order (no TF32); it runs far below the tensor-core peak.
//
// Residual for the backward (csrc/flash_attention_bwd.cu): when the caller
// passes a non-null `lse` ([B, H, Tq] float32), every path also writes each
// row's log-sum-exp m + log(l) of the scaled logits, as the TPU kernel does
// with save_residuals=True.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 128;

// ---------------------------------------------------------------- FMA path

template <int BQ, int BK>
size_t smem_bytes(int s) {
  size_t floats = (size_t)s * BQ          // q, transposed [s][BQ]
                  + (size_t)BK * (s + 1)  // k [BK][s+1]
                  + (size_t)BK * s        // v [BK][s]
                  + (size_t)BQ * (BK + 1) // p [BQ][BK+1]
                  + (size_t)BQ * s        // output accumulator [BQ][s]
                  + 3 * BQ;               // m, l, alpha
  return floats * sizeof(float);
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int tq, int tk, int h, int s,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  const int sk = s + 1;
  float* qs = smem;                // [s][BQ]
  float* ks = qs + s * BQ;         // [BK][s+1]
  float* vs = ks + BK * sk;        // [BK][s]
  float* ps = vs + BK * s;         // [BQ][BK+1]
  float* os = ps + BQ * (BK + 1);  // [BQ][s]
  float* m_s = os + BQ * s;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / h;
  const int head = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const long tok = (long)h * s;  // stride between consecutive tokens
  const T* qb = q + (long)b * tq * tok + (long)head * s;
  const T* kb = k + (long)b * tk * tok + (long)head * s;
  const T* vb = v + (long)b * tk * tok + (long)head * s;
  T* ob = o + (long)b * tq * tok + (long)head * s;

  for (int i = tid; i < BQ * s; i += kThreads) {
    const int r = i / s, c = i % s, t = q0 + r;
    qs[c * BQ + r] = t < tq ? to_f32(qb[t * tok + c]) : 0.f;
    os[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // Q K^T: each thread owns one key column and RPT consecutive query rows.
  constexpr int kGroups = kThreads / BK;
  constexpr int RPT = BQ / kGroups;
  static_assert(kThreads % BK == 0 && BQ % kGroups == 0, "tile shape");
  const int col = tid % BK;
  const int r0 = (tid / BK) * RPT;
  const int warp = tid / 32, lane = tid % 32;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // previous tile's readers of ks/vs/ps are done
    for (int i = tid; i < BK * s; i += kThreads) {
      const int r = i / s, c = i % s, t = k0 + r;
      const bool ok = t < tk;
      ks[r * sk + c] = ok ? to_f32(kb[t * tok + c]) : 0.f;
      vs[i] = ok ? to_f32(vb[t * tok + c]) : 0.f;
    }
    __syncthreads();

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
    for (int j = 0; j < RPT; ++j) ps[(r0 + j) * (BK + 1) + col] = valid ? acc[j] * scale : -INFINITY;
    __syncthreads();

    // Online softmax, one warp per row.  Column 0 of every tile is a real
    // key (k0 < tk), so each row max is finite.
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float* prow = ps + r * (BK + 1);
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(prow[j] - m_new);
        prow[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
    for (int i = tid; i < BQ * s; i += kThreads) {
      const int r = i / s, c = i % s;
      const float* prow = ps + r * (BK + 1);
      float pv = 0.f;
      for (int j = 0; j < BK; ++j) pv = fmaf(prow[j], vs[j * s + c], pv);
      os[i] = os[i] * a_s[r] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * s; i += kThreads) {
    const int r = i / s, c = i % s, t = q0 + r;
    if (t < tq) ob[t * tok + c] = from_f32<T>(os[i] / l_s[r]);
  }
  if (lse != nullptr) {
    float* lb = lse + (long)blockIdx.y * tq;  // blockIdx.y = b * h + head
    for (int r = tid; r < BQ; r += kThreads)
      if (q0 + r < tq) lb[q0 + r] = m_s[r] + logf(l_s[r]);
  }
}

template <typename T, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int tq, int tk, int h, int s, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<BQ, BK>(s);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, tq, tk, h, s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int b, int tq, int tk, int h, int s, float scale,
                         cudaStream_t stream) {
  if (s <= 160) return launch<T, 64, 64>(q, k, v, o, lse, b, tq, tk, h, s, scale, stream);
  return launch<T, 16, 32>(q, k, v, o, lse, b, tq, tk, h, s, scale, stream);
}

// ------------------------------------------------------ tensor-core path

constexpr int kMmaRows = 64;  // query rows per block: 4 warps x 16
constexpr int kMmaKeys = 64;  // keys per kv tile

// Shared memory: Q [64][SP+8], then two stages of K [64][SP+8], V [64][SP+8].
template <int SP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kMmaRows + 4 * kMmaKeys) * (SP + 8) * sizeof(bf16);
}

// SP: the head dim rounded up to a multiple of 16 (the mma k-step).
template <int SP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int tq, int tk, int h, int s, float scale_log2) {
  constexpr int LD = SP + 8;  // row stride in elements (16 bytes of pad)
  constexpr int KS = SP / 16;
  constexpr int CH = SP / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kvs = qs + kMmaRows * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y / h;
  const int head = blockIdx.y % h;
  const int q0 = blockIdx.x * kMmaRows;
  const long tok = (long)h * s;
  const bf16* qb = q + (long)b * tq * tok + (long)head * s;
  const bf16* kb = k + (long)b * tk * tok + (long)head * s;
  const bf16* vb = v + (long)b * tk * tok + (long)head * s;
  bf16* ob = o + (long)b * tq * tok + (long)head * s;

  for (int i = tid; i < kMmaRows * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8, t = q0 + r;
    const bool ok = t < tq && c < s;
    cp_async16(qs + r * LD + c, qb + (ok ? (long)t * tok + c : 0), ok);
  }
  auto load_kv = [&](int tile) {
    bf16* ksm = kvs + (tile & 1) * 2 * kMmaKeys * LD;
    bf16* vsm = ksm + kMmaKeys * LD;
    for (int i = tid; i < kMmaKeys * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8, t = tile * kMmaKeys + r;
      const bool ok = t < tk && c < s;
      const long off = ok ? (long)t * tok + c : 0;
      cp_async16(ksm + r * LD + c, kb + off, ok);
      cp_async16(vsm + r * LD + c, vb + off, ok);
    }
  };
  load_kv(0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float oacc[SP / 8][4];
#pragma unroll
  for (int n = 0; n < SP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // rows g and g+8 of this warp's 16: running max (log2 units) and this
  // thread's share of the running sum (the quad's four add up at the end)
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  const int ntiles = (tk + kMmaKeys - 1) / kMmaKeys;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
    const bf16* ksm = kvs + (it & 1) * 2 * kMmaKeys * LD;
    const bf16* vsm = ksm + kMmaKeys * LD;

    // S = Q K^T: 8 n-tiles of 8 keys.  K [key][dim] is the col-major B.
    float sacc[8][4];
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

    // Online softmax in log2 units.  Element e of n-tile j is row g + 8*(e/2),
    // key it*64 + 8j + 2*t4 + (e&1).  Every tile's first key is real, so the
    // row max is finite.
    const int key0 = it * kMmaKeys + 2 * t4;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = key0 + j * 8 + (e & 1) < tk ? sacc[j][e] * scale_log2 : -INFINITY;
        sacc[j][e] = val;
        mx[e / 2] = fmaxf(mx[e / 2], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < SP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e / 2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[j][e] - m_r[e / 2]);
        l_r[e / 2] += p;
        sacc[j][e] = p;
      }

    // O += P V.  The S accumulators of n-tiles 2kk, 2kk+1 are the A fragment
    // of key step kk; V [key][dim] is the row-major B (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pf[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < SP / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vsm + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                              (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], pf, bf[0], bf[1]);
        mma_bf16(oacc[2 * dp + 1], pf, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = 1.f / l;
    // natural-log lse: m_r is the row max of the logits times log2(e)
    const int t = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && t4 == 0 && t < tq)
      lse[(long)blockIdx.y * tq + t] = m_r[r] * 0.6931471805599453f + logf(l);
  }
  const int row = q0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < SP / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c >= s) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row + 8 * r;
      if (t < tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)t * tok + c) =
            __floats2bfloat162_rn(oacc[n][2 * r] * inv_l[r], oacc[n][2 * r + 1] * inv_l[r]);
    }
  }
}

template <int SP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                       int tq, int tk, int h, int s, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<SP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<SP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kMmaRows - 1) / kMmaRows, b * h);
  flash_fwd_mma_kernel<SP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, tq, tk, h, s, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The tensor-core path's head dims: S % 8 == 0 (16-byte rows), S <= 160.
bool takes_mma(const void* q, const void* k, const void* v, const void* o, int s) {
  return s % 8 == 0 && s <= 160 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

// The wgmma path's operands: TMA needs 16-byte aligned bases and strides.
bool takes_wgmma(const void* q, const void* k, const void* v, const void* o, int s) {
  return s % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int b, int tq, int tk, int h, int s, float scale, cudaStream_t st) {
  switch ((s + 15) / 16) {
    case 1: return launch_mma<16>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
    case 2: return launch_mma<32>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
    case 3: return launch_mma<48>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
    case 4: return launch_mma<64>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
    case 5: return launch_mma<80>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
    case 6: case 7: case 8: return launch_mma<128>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
    default: return launch_mma<160>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
  }
}

// ------------------------------------------------------------ wgmma path

// KSTEPS k-steps of 16 head-dim columns in Q K^T; NO output columns per CTA
// (blockIdx.z selects the slice); BK keys per kv tile; NWG consumer
// warpgroups of 64 query rows each; STAGES kv stages.
template <int KSTEPS, int NO, int BK, int NWG, int STAGES, int CTAS>
struct FwdWgmma {
  static constexpr int BQ = 64 * NWG;
  static constexpr int KCH = (KSTEPS * 16 + 63) / 64;  // 64-column chunks of Q and K
  static constexpr int VCH = (NO + 63) / 64;           // chunks of this CTA's V slice
  static constexpr int Q_BYTES = KCH * BQ * 128;
  static constexpr int K_BYTES = KCH * BK * 128;
  static constexpr int STAGE_BYTES = K_BYTES + VCH * BK * 128;
  static constexpr int THREADS = NWG * 128 + 32;  // + one producer warp
  // 1024 bytes to align the dynamic base, the tiles, 64 bytes of barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 64;
  static_assert(1 + 2 * STAGES <= 8, "barrier space");
  static_assert(NO % 8 == 0 && NO <= 256 && BK % 16 == 0, "wgmma shape");
  // a slice after the first starts at a 64-column chunk
  static_assert(NO % 64 == 0 || NO + 15 >= KSTEPS * 16, "column slice");
};

template <int KSTEPS, int NO, int BK, int NWG, int STAGES, int CTAS>
__global__ void __launch_bounds__(NWG * 128 + 32, CTAS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                       float* __restrict__ lse, int tq, int tk, int h, int s, float scale_log2) {
  using C = FwdWgmma<KSTEPS, NO, BK, NWG, STAGES, CTAS>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* kv = qs + C::Q_BYTES;  // stage i: K chunks, then V chunks
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + STAGES * C::STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * C::BQ;
  const int n0 = blockIdx.z * NO;
  const int ntiles = (tk + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_load_tile(qs, &qmap, q_full, 0, C::KCH, C::BQ, head, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        unsigned char* ks = kv + st * C::STAGE_BYTES;
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        tma_load_tile(ks, &kmap, &full[st], 0, C::KCH, BK, head, j * BK, b);
        tma_load_tile(ks + C::K_BYTES, &vmap, &full[st], n0 / 64, C::VCH, BK, head, j * BK, b);
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
  mbar_wait(q_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t ks_a = smem_u32(kv + st * C::STAGE_BYTES);
    const uint32_t vs_a = ks_a + C::K_BYTES;

    // S = Q K^T, 64 x BK per warpgroup
    float sacc[BK / 2];
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaSS<BK>::run(sacc, desc_kmajor(qs_a, C::BQ, wg * 64, kk), desc_kmajor(ks_a, BK, 0, kk),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // Online softmax in log2 units over keys j*BK + 8jj + 2t4 + (e & 1);
    // every tile's first key is real, so each row max is finite; only the
    // last tile can hold padded keys.
    // (the max is taken on the unscaled scores: the scale is positive)
    const int key0 = j * BK + 2 * t4;
    const bool ragged = (j + 1) * BK > tk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (ragged && key0 + (i / 4) * 8 + (i & 1) >= tk) sacc[i] = -INFINITY;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sacc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
      alpha[r] = ex2(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) oacc[i] *= alpha[(i % 4) / 2];
    // P, rounded to bf16 as the plain version's weights are, packed as the
    // A operand of P V
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = ex2(fmaf(sacc[i], scale_log2, -m_r[(i % 4) / 2]));
      l_r[(i % 4) / 2] += p;
      sacc[i] = p;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);

    // O += P V, V the MN-major B operand
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<NO>::run(oacc, pf[kk], desc_mnmajor(vs_a, BK, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    mbar_arrive(&empty[st]);  // this stage may be refilled
  }

  const long tok = (long)h * s;
  bf16* ob = o + (long)b * tq * tok + (long)head * s;
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = 1.f / l;
    const int t = r0 + g + 8 * r;
    if (lse != nullptr && blockIdx.z == 0 && t4 == 0 && t < tq)
      lse[(long)blockIdx.y * tq + t] = m_r[r] * 0.6931471805599453f + logf(l);
  }
#pragma unroll
  for (int n = 0; n < NO / 8; ++n) {
    const int c = n0 + n * 8 + 2 * t4;
    if (c >= s) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + g + 8 * r;
      if (t < tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)t * tok + c) = __floats2bfloat162_rn(
            oacc[4 * n + 2 * r] * inv_l[r], oacc[4 * n + 2 * r + 1] * inv_l[r]);
    }
  }
}

// geometry: {rows per CTA, keys per tile, output columns per CTA, stages,
// dynamic shared bytes, CTAs per SM}, from ops/flash_attention.py's
// wgmma_geometry; a geometry this build does not hold is refused.
template <int KSTEPS, int NO, int BK, int NWG, int STAGES, int CTAS>
bool fwd_geometry_is(const int* geo, int s) {
  using C = FwdWgmma<KSTEPS, NO, BK, NWG, STAGES, CTAS>;
  return geo[0] == C::BQ && geo[1] == BK && geo[2] == NO && geo[3] == STAGES &&
         geo[4] == C::SMEM && geo[5] == CTAS && KSTEPS == (s + 15) / 16;
}

template <int KSTEPS, int NO, int BK, int NWG, int STAGES, int CTAS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                         int tq, int tk, int h, int s, float scale, cudaStream_t stream) {
  using C = FwdWgmma<KSTEPS, NO, BK, NWG, STAGES, CTAS>;
  CUtensorMap qm, km, vm;
  cudaError_t err = hopper::make_tile_map(&qm, q, b, tq, h, s, C::BQ);
  if (err == cudaSuccess) err = hopper::make_tile_map(&km, k, b, tk, h, s, BK);
  if (err == cudaSuccess) err = hopper::make_tile_map(&vm, v, b, tk, h, s, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<KSTEPS, NO, BK, NWG, STAGES, CTAS>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((tq + C::BQ - 1) / C::BQ, b * h, (s + NO - 1) / NO);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, static_cast<bf16*>(o), lse, tq, tk, h,
                                                s, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The models' head dims (U-Net 40, 80, 160; autoencoder 512).
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                           int tq, int tk, int h, int s, float scale, const int* geo,
                           cudaStream_t st) {
#define LDM_FWD(...)                                    \
  if (fwd_geometry_is<__VA_ARGS__>(geo, s))             \
    return launch_wgmma<__VA_ARGS__>(q, k, v, o, lse, b, tq, tk, h, s, scale, st)
  switch (s) {
    case 40: LDM_FWD(3, 40, 64, 2, 2, 2); break;
    case 80: LDM_FWD(5, 80, 128, 2, 2, 1); break;
    case 160: LDM_FWD(10, 160, 64, 1, 2, 1); break;
    case 512: LDM_FWD(32, 128, 64, 1, 2, 1); break;
  }
  return cudaErrorInvalidValue;
#undef LDM_FWD
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 for bfloat16
// operands, 0 for float32.  lse: null, or [B, H, Tq] float32 for the
// backward's residual.  geometry: null, or the wgmma path's launch geometry
// (bf16 at the models' head dims; the caller's wgmma_geometry).  *path
// receives the path taken: 0 FMA, 1 mma.sync, 2 wgmma.  The caller checks
// shapes (s <= 512, tk >= 1).
extern "C" int ldm_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int b, int tq, int tk, int h, int s,
                                       float scale, int is_bf16, const int* geometry, int* path,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && geometry != nullptr && takes_wgmma(q, k, v, o, s)) {
    *path = 2;
    err = dispatch_wgmma(q, k, v, o, lse, b, tq, tk, h, s, scale, geometry, st);
  } else if (is_bf16 && takes_mma(q, k, v, o, s)) {
    *path = 1;
    err = dispatch_mma(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
  } else {
    *path = 0;
    err = is_bf16 ? dispatch_fma<bf16>(q, k, v, o, lse, b, tq, tk, h, s, scale, st)
                  : dispatch_fma<float>(q, k, v, o, lse, b, tq, tk, h, s, scale, st);
  }
  return static_cast<int>(err);
}
