// The ResBlock chain GroupNorm -> SiLU -> 3x3 SAME conv (stride 1) ->
// + bias (+ time) (+ residual), for Hopper (sm_90a).
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/fused_conv.py::_kernel (through
// _pallas_call and _fused): one image's [HW, Cin] slab in VMEM, GN stats by
// one-hot matmuls, normalize + SiLU once per image into a zero-padded row
// slab, the conv as 9 shifted slab dots, the epilogue adds; Cout
// block-gridded.
//
// What it computes, in the TPU kernel's formula:
//   stats   float32 sums per (image, group); var = max(E[x^2] - mean^2, 0)
//           (the chain CLAMPS the fast variance; the GroupNorm kernels of
//           group_norm.cu do not); rstd = 1 / sqrt(var + eps)
//   y       = silu((x - mean) * (rstd * gamma) + beta) in float32, cast to
//           x's type; the SAME border is zeros of y, not of x
//   acc     = sum over 9 taps and Cin of y * w in float32 (products of
//           x-type values)
//   out     = T(acc) + bias, then + time_add[b, co], then + residual, each
//           add in x's type T (bf16 adds round at every step)
//
// Layout: x, y [B, H, W, Cin] (NHWC); gamma, beta [Cin] float32; w [Cout,
// Cin, 3, 3] (the port's OIHW, read in place by the mma.sync and FMA
// paths); wr [9, Cout, Cin] (the same weights relaid once per weight by the
// wrapper, ops/fused_conv.py::relaid_weight: the wgmma path's K-major B);
// bias [Cout] in T; time_add [B, Cout] and residual [B, H, W, Cout] in T;
// out [B, H, W, Cout] in T.
//
// What bounds it on this card: at the U-Net's 32x32 and 16x16 levels the
// products (2 * M * Cout * 9 * Cin operations, M = B*H*W, against about
// M * (Cin + 2 * Cout) + 9 * Cin * Cout elements moved) are far above the
// card's operations-per-byte ratio, so the conv runs on the bf16 tensor
// cores; at the 8x8 and 4x4 levels (M = 256, 64) the 29-59 MB of weights
// are the bound.
//
// Design, three launches (four with split-K), all in one call:
//  1-2. gn_stats.cuh, one launch: per-channel sums, then per-channel mean
//       and rstd * gamma, with the clamp;
//  3.   gn_stats.cuh's normalize: y = silu(...) in T, written once.  Like the
//       TPU kernel's slab, each element is normalized once; y makes one
//       round trip through device memory (2 * M * Cin elements), where
//       normalizing in the conv's prologue instead recomputed it for every
//       tap and every Cout tile that reads it;
//  4.   the conv, an implicit GEMM over M = B*H*W rows, N = Cout, K = 9 * Cin,
//       on one of three paths (the wrapper's conv_plan chooses; the C entry
//       reports the path taken):
//   * wgmma path (bf16, Cin % 64 == 0, Cout % 8 == 0: every chain of the
//     U-Net and the autoencoders): a CTA owns a BM x BN output tile and a
//     range of k-steps, a k-step being one tap and 64 input channels.  BM:
//     one or two consumer warpgroups of one or two 64-row sub-tiles each
//     (64 rows at M <= 64, 256 at 128 < M <= 256, else 128); BN = 160 or
//     128 (128 where a warpgroup holds two sub-tiles: 256 x 160 float32
//     sums would take 160 registers a thread, and four warpgroups are
//     capped at 96 registers, 17 warps sharing 4 register files).  A
//     producer warp issues TMA loads into a ring of stages signalled by
//     mbarriers: the A tile is one box {64 channels, bw, bh, bb} of a 4-D
//     map over y (bw * bh * bb = BM pixels, the M tile a block of whole
//     rows and images), loaded at coordinates shifted by the tap, so TMA's
//     zero fill of everything outside the tensor, negative coordinates
//     included, is exactly the SAME border of y; the B tile is one box {64,
//     BN, 1} of a map over wr.  Both are one-chunk K-major tiles with the
//     128-byte swizzle (hopper.cuh), read by SS wgmma m64nBNk16, four
//     k-steps of 16 channels per stage; the products of stage j run while
//     stage j - 1's are retired and its slot refilled.  Where the output has
//     too few tiles to fill the card (the 16x16 and smaller levels) the
//     k-steps are split over blockIdx.z, each split writing float32 partial
//     sums to its own slot; launch 5 adds them in split order and applies
//     the epilogue, so the result is deterministic.  At M <= 256 one M tile
//     covers every pixel, so each weight byte is read once per call.
//     Otherwise the epilogue runs from the accumulator registers.
//   * mma.sync path (bf16 shapes the wgmma path does not take, Cin % 32 ==
//     0, 16-byte aligned y and w): a 64 x 64 output tile per block of 4
//     warps, mma.sync m16n8k16; A (32 channels of 64 shifted pixels) through
//     cp.async, whose zero-fill supplies the SAME border; the weights read
//     in place from OIHW and scattered into 9 per-tap tiles; split-K as
//     above.
//   * FMA path (float32, whose products the TPU computes exactly, so TF32
//     would change results; and shapes no other path takes): a 64 x 64 tile
//     per block of 256 threads (4 x 4 outputs each), float32 FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "gn_stats.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;

// out = T(acc) + bias, then + time_add, then + residual, each add rounded
// to T, as the TPU kernel's epilogue runs in the output type.
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* __restrict__ bias,
                                      const T* __restrict__ time_add,
                                      const T* __restrict__ residual, int img, long m, int co,
                                      int cout) {
  float v = to_f32(from_f32<T>(acc));
  v = to_f32(from_f32<T>(v + to_f32(bias[co])));
  if (time_add) v = to_f32(from_f32<T>(v + to_f32(time_add[(long)img * cout + co])));
  if (residual) v = to_f32(from_f32<T>(v + to_f32(residual[m * cout + co])));
  return from_f32<T>(v);
}

// ------------------------------------------------------ tensor-core path

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;        // shared row stride in elements (80 bytes)
constexpr int kSpan = BK * 9 / 8;  // 16-byte chunks of one co's weights per channel block
static_assert(BN * kSpan == 18 * kThreads, "each thread moves 18 chunks, 2 per k-step");
constexpr int kStagesA = 3;
constexpr int A_STAGE = BM * LDS;
constexpr int B_STAGE = 9 * BN * LDS;  // the 9 taps of one channel block
constexpr size_t kMmaSmem = (kStagesA * A_STAGE + 2 * B_STAGE) * sizeof(bf16);

// Grid (M tiles, N tiles, splits); block z reduces channel blocks
// [z * per_split, min((z + 1) * per_split, Cin / 32)).  partial: null when
// splits == 1 (the epilogue runs here), else [splits, M, Cout] float32.
__global__ void __launch_bounds__(kThreads)
conv_mma_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, const bf16* __restrict__ time_add,
                const bf16* __restrict__ residual, bf16* __restrict__ out,
                float* __restrict__ partial, int h, int wd, int cin, int cout, int m_total,
                int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [kStagesA][BM][LDS]
  bf16* bs = as + kStagesA * A_STAGE;            // [2][9][BN][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = h * wd;
  const int cb0 = blockIdx.z * per_split;
  const int cb_end = min(cb0 + per_split, cin / BK);
  const int k_steps = 9 * (cb_end - cb0);

  // A: pixel row tid / 2, 16 channels from (tid % 2) * 16: two 16-byte
  // cp.async, zero-filled where the shifted pixel leaves its image.
  const int lrow = tid / 2, lhalf = (tid % 2) * 16;
  const int am = m0 + lrow;
  const bool a_row_ok = am < m_total;
  const int a_img = a_row_ok ? am / hw : 0;
  const int a_rem = a_row_ok ? am % hw : 0;
  const int a_y = a_rem / wd, a_x = a_rem % wd;
  auto load_a = [&](int stage, int ks) {
    const int tap = ks % 9, ci0 = (cb0 + ks / 9) * BK + lhalf;
    const int yy = a_y + tap / 3 - 1, xx = a_x + tap % 3 - 1;
    const bool ok = a_row_ok && yy >= 0 && yy < h && xx >= 0 && xx < wd;
    const bf16* src = y + (ok ? ((long)a_img * hw + (long)yy * wd + xx) * cin + ci0 : 0);
    bf16* dst = as + stage * A_STAGE + lrow * LDS + lhalf;
    cp_async16(dst, src, ok);
    cp_async16(dst + 8, src + 8, ok);
  };

  // B: chunk i = tid + 128 * r (r < 18) is 16-byte chunk i % 36 of output
  // channel n0 + i / 36's span; part p (0..8) of a block is chunks r = 2p,
  // 2p + 1, fetched one k-step ahead and scattered into [tap][co][ci].
  auto fetch_b = [&](uint4 (&wb)[2], int cb, int part) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + kThreads * (2 * part + u);
      const int co = n0 + i / kSpan;
      wb[u] = co < cout ? __ldg(reinterpret_cast<const uint4*>(
                              w + ((long)co * cin + (long)cb * BK) * 9) + i % kSpan)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_b = [&](const uint4 (&wb)[2], int stage, int part) {
    unsigned short* dst = reinterpret_cast<unsigned short*>(bs + stage * B_STAGE);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + kThreads * (2 * part + u);
      const int row = i / kSpan, p0 = (i % kSpan) * 8;
      const uint32_t words[4] = {wb[u].x, wb[u].y, wb[u].z, wb[u].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int p = p0 + e;  // ci_local * 9 + tap
        dst[((p % 9) * BN + row) * LDS + p / 9] =
            (unsigned short)(e & 1 ? words[e / 2] >> 16 : words[e / 2] & 0xffffu);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (k_steps > 0) {
    {  // the first block's weights: all 18 loads in flight, then the scatter
      uint4 first[9][2];
#pragma unroll
      for (int part = 0; part < 9; ++part) fetch_b(first[part], cb0, part);
#pragma unroll
      for (int part = 0; part < 9; ++part) store_b(first[part], 0, part);
    }
#pragma unroll
    for (int s = 0; s < kStagesA - 1; ++s) {
      if (s < k_steps) load_a(s, s);
      cp_async_commit();
    }
  }
  uint4 wb[2];
  for (int ks = 0; ks < k_steps; ++ks) {
    const int cb = ks / 9, tap = ks % 9;
    const bool next_b = cb0 + cb + 1 < cb_end;
    cp_async_wait<kStagesA - 2>();
    __syncthreads();  // A stage ks and B block cb have landed; ks - 1 is done
    const int next = ks + kStagesA - 1;
    if (next < k_steps) load_a(next % kStagesA, next);
    cp_async_commit();
    if (next_b) fetch_b(wb, cb0 + cb + 1, tap);  // in flight over the products
    const bf16* a_t = as + (ks % kStagesA) * A_STAGE;
    const bf16* b_t = bs + (cb & 1) * B_STAGE + tap * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], a_t + (wm * 32 + i * 16 + lane % 16) * LDS + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bf[4];
        ldsm_x4(bf, b_t + (wn * 32 + jp * 16 + lane % 8 + (lane / 16) * 8) * LDS + kk * 16 +
                        ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    // block cb + 1's B stage was last read in block cb - 1, before a barrier
    if (next_b) store_b(wb, (cb + 1) & 1, tap);
  }
  cp_async_wait<0>();

  // Element e of tile (i, j): row g + 8 * (e / 2), column 2 * t4 + (e & 1).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * r;
      if (m >= m_total) continue;
      const int img = m / hw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int co = n0 + wn * 32 + j * 8 + 2 * t4 + c;
          if (co >= cout) continue;
          const float v = acc[i][j][2 * r + c];
          if (partial != nullptr)
            partial[((long)blockIdx.z * m_total + m) * cout + co] = v;
          else
            out[(long)m * cout + co] = epilogue<bf16>(v, bias, time_add, residual, img, m, co, cout);
        }
      }
    }
  }
}

// Launch 5 of split-K: out = epilogue(sum of the splits' partials, in order).
template <typename T>
__global__ void __launch_bounds__(256)
splitk_epilogue_kernel(const float* __restrict__ partial, const T* __restrict__ bias,
                       const T* __restrict__ time_add, const T* __restrict__ residual,
                       T* __restrict__ out, int hw, int cout, int m_total, int splits) {
  const long total = (long)m_total * cout;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += partial[z * total + i];
    const long m = i / cout;
    out[i] = epilogue<T>(v, bias, time_add, residual, (int)(m / hw), m, (int)(i % cout), cout);
  }
}

// ------------------------------------------------------------ wgmma path

// Grid (M tiles, N tiles, splits).  M tile t covers pixels x0 .. x0 + bw,
// y0 .. y0 + bh of images b0 .. b0 + bb; split z reduces k-steps
// [z * per_split, min((z + 1) * per_split, k_total)), k-step it being tap
// it % 9 of channels 64 * (it / 9) ...  partial: null when there is one
// split (the epilogue runs here), else [splits, M, Cout] float32.
template <int NWG, int MT, int BN, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, const bf16* __restrict__ bias,
                  const bf16* __restrict__ time_add, const bf16* __restrict__ residual,
                  bf16* __restrict__ out, float* __restrict__ partial, int b, int h, int wd,
                  int cout, int bw, int bh, int bb, int tiles_x, int tiles_y, int k_total,
                  int per_split) {
  using C = hopper::ConvTiles<NWG, MT, BN, STAGES>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = blockIdx.x;
  const int x0 = tm % tiles_x * bw, y0 = tm / tiles_x % tiles_y * bh;
  const int b0 = tm / (tiles_x * tiles_y) * bb;
  const int n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * per_split;
  const int nk = min(per_split, k_total - k0);
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES, it = k0 + j, tap = it % 9;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        unsigned char* a = ring + st * C::STAGE_BYTES;
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        tma_load_4d(a, &amap, &full[st], (it / 9) * 64, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b0);
        tma_load_4d(a + C::A_BYTES, &bmap, &full[st], (it / 9) * 64, n0, tap, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows 64 (MT wg + mt) .. + 63, mt < MT
  const int wg = warp / 4;
  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t a = smem_u32(ring + st * C::STAGE_BYTES);
    const uint32_t bt = a + C::A_BYTES;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        WgmmaSS<BN>::run(acc[mt], desc_kmajor(a, C::BM, (wg * MT + mt) * 64, kk),
                         desc_kmajor(bt, BN, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // stage j - 1's products are done: refill its slot
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    if (j > 0) mbar_arrive(&empty[(j - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

  // Register 4j + e of sub-tile mt holds its row 16 (warp % 4) + g + 8 (e / 2),
  // column 8j + 2 t4 + (e % 2); tile row r is pixel (x0 + r % bw, y0 + r / bw
  // % bh) of image b0 + r / (bw * bh), in the box's order.
  const int g = lane / 4, t4 = lane % 4;
  const long m_total = (long)b * h * wd;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (wg * MT + mt) * 64 + (warp % 4) * 16 + g + 8 * half;
      const int x = x0 + r % bw, y = y0 + r / bw % bh, img = b0 + r / (bw * bh);
      if (x >= wd || y >= h || img >= b) continue;
      const long m = ((long)img * h + y) * wd + x;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * t4;
        if (co >= cout) continue;
        const float v0 = acc[mt][4 * j + 2 * half], v1 = acc[mt][4 * j + 2 * half + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(partial + ((long)blockIdx.z * m_total + m) * cout + co) =
              make_float2(v0, v1);
        } else {
          __nv_bfloat162 pair;
          pair.x = epilogue<bf16>(v0, bias, time_add, residual, img, m, co, cout);
          pair.y = epilogue<bf16>(v1, bias, time_add, residual, img, m, co + 1, cout);
          *reinterpret_cast<__nv_bfloat162*>(out + m * cout + co) = pair;
        }
      }
    }
  }
}

template <int NWG, int MT, int BN, int STAGES>
cudaError_t launch_conv_wgmma(const bf16* y, const bf16* wr, const bf16* bias,
                              const bf16* time_add, const bf16* residual, bf16* out,
                              float* partial, int b, int h, int wd, int cin, int cout,
                              const int* geo, cudaStream_t st) {
  using C = hopper::ConvTiles<NWG, MT, BN, STAGES>;
  const int bw = geo[4], bh = geo[5], bb = geo[6], per_split = geo[7];
  CUtensorMap am, bm;
  cudaError_t err = hopper::make_bf16_map(&am, y, {cin, wd, h, b}, {64, bw, bh, bb});
  if (err == cudaSuccess) err = hopper::make_bf16_map(&bm, wr, {cin, cout, 9, 1}, {64, BN, 1, 1});
  if (err != cudaSuccess) return err;
  auto kernel = conv_wgmma_kernel<NWG, MT, BN, STAGES>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int tiles_x = (wd + bw - 1) / bw, tiles_y = (h + bh - 1) / bh;
  const int tiles_b = (b + bb - 1) / bb;
  const int k_total = 9 * (cin / 64);
  const int splits = (k_total + per_split - 1) / per_split;
  const dim3 grid(tiles_x * tiles_y * tiles_b, (cout + BN - 1) / BN, splits);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(am, bm, bias, time_add, residual, out,
                                           splits > 1 ? partial : nullptr, b, h, wd, cout, bw,
                                           bh, bb, tiles_x, tiles_y, k_total, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int m_total = b * h * wd;
  const long total = (long)m_total * cout;
  const long nblk = (total + 255) / 256;
  splitk_epilogue_kernel<bf16><<<(unsigned)(nblk < 132 * 16 ? nblk : 132 * 16), 256, 0, st>>>(
      partial, bias, time_add, residual, out, h * wd, cout, m_total, splits);
  return cudaGetLastError();
}

// The instantiations: ops/quant_conv.py's CONV_WGMMA_STAGES.
cudaError_t dispatch_conv_wgmma(const bf16* y, const bf16* wr, const bf16* bias,
                                const bf16* time_add, const bf16* residual, bf16* out,
                                float* partial, int b, int h, int wd, int cin, int cout,
                                const int* geo, cudaStream_t st) {
#define LDM_CONV(...)                                                                    \
  if (hopper::conv_geometry_is<__VA_ARGS__>(geo))                                        \
    return launch_conv_wgmma<__VA_ARGS__>(y, wr, bias, time_add, residual, out, partial, b, \
                                          h, wd, cin, cout, geo, st)
  LDM_CONV(1, 1, 128, 8);
  LDM_CONV(1, 1, 160, 8);
  LDM_CONV(2, 1, 128, 7);
  LDM_CONV(2, 1, 160, 6);
  LDM_CONV(2, 2, 128, 4);
  return cudaErrorInvalidValue;
#undef LDM_CONV
}

// ---------------------------------------------------------------- FMA path

constexpr int kFmaThreads = 256;
constexpr int FM = 64, FN = 64, FK = 16;

template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
conv_fma_kernel(const T* __restrict__ y, const T* __restrict__ w, const T* __restrict__ bias,
                const T* __restrict__ time_add, const T* __restrict__ residual,
                T* __restrict__ out, int h, int wd, int cin, int cout, int m_total) {
  __shared__ float as[FK][FM];
  __shared__ float bs[FK][FN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  const int hw = h * wd;
  const int lrow = tid / 4, lcol = (tid % 4) * 4;
  const int am = m0 + lrow;
  const bool a_row_ok = am < m_total;
  const int a_img = a_row_ok ? am / hw : 0;
  const int a_rem = a_row_ok ? am % hw : 0;
  const int a_y = a_rem / wd, a_x = a_rem % wd;
  const int bco = n0 + lrow;
  const int ty = tid / 16, tx = tid % 16;
  const int k_steps = 9 * ((cin + FK - 1) / FK);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int ks = 0; ks < k_steps; ++ks) {
    const int tap = ks % 9, ci0 = (ks / 9) * FK;
    const int yy = a_y + tap / 3 - 1, xx = a_x + tap % 3 - 1;
    const bool ok = a_row_ok && yy >= 0 && yy < h && xx >= 0 && xx < wd;
    const long pix = ((long)a_img * hw + (long)yy * wd + xx) * cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + lcol + j;
      as[lcol + j][lrow] = ok && ci < cin ? to_f32(y[pix + ci]) : 0.f;
      bs[lcol + j][lrow] =
          bco < cout && ci < cin ? to_f32(w[((long)bco * cin + ci) * 9 + tap]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = as[k][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = bs[k][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= m_total) continue;
    const int img = m / hw;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = n0 + tx * 4 + c;
      if (co < cout)
        out[(long)m * cout + co] =
            epilogue<T>(acc[r][c], bias, time_add, residual, img, m, co, cout);
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const float* gamma, const float* beta, const void* w,
                const void* wr, const void* bias, const void* time_add, const void* residual,
                void* out, void* y, float* scratch, float* partial, unsigned* tickets, int b,
                int h, int wd, int cin, int cout, int groups, int chunks, int gps, int vec,
                int splits, float eps, const int* geometry, int* path, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  float* mean = scratch;
  float* factor = mean + (long)b * cin;
  // split-K partials go after mean and factor, 16-byte aligned
  float* sk = factor + (((long)b * cin + 3) / 4) * 4;
  cudaError_t err = gn_stats<T>(xt, gamma, mean, factor, partial, tickets, b, h * wd, cin,
                                groups, chunks, gps, vec, eps, /*clamp=*/1, st);
  if (err != cudaSuccess) return err;
  err = gn_normalize<T>(xt, mean, factor, beta, yt, b, h * wd, cin, /*activate=*/1, st);
  if (err != cudaSuccess) return err;
  const int m_total = b * h * wd;
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  const T* tt = static_cast<const T*>(time_add);
  const T* rt = static_cast<const T*>(residual);
  T* ot = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    if (geometry != nullptr) {  // the caller's plan: wgmma, or an error
      *path = 2;
      if (cin % 64 != 0 || cout % 8 != 0 || !aligned16(y) || !aligned16(wr))
        return cudaErrorInvalidValue;
      return dispatch_conv_wgmma(yt, static_cast<const bf16*>(wr), bt, tt, rt, ot, sk, b, h, wd,
                                 cin, cout, geometry, st);
    }
    if (cin % BK == 0 && aligned16(y) && aligned16(w)) {
      *path = 1;
      err = cudaFuncSetAttribute(conv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kMmaSmem);
      if (err != cudaSuccess) return err;
      const int blocks = cin / BK;
      const int per_split = (blocks + splits - 1) / splits;
      const int used = (blocks + per_split - 1) / per_split;
      const dim3 grid((m_total + BM - 1) / BM, (cout + BN - 1) / BN, used);
      conv_mma_kernel<<<grid, kThreads, kMmaSmem, st>>>(yt, wt, bt, tt, rt, ot,
                                                        used > 1 ? sk : nullptr, h, wd, cin,
                                                        cout, m_total, per_split);
      err = cudaGetLastError();
      if (err != cudaSuccess || used == 1) return err;
      const long total = (long)m_total * cout;
      const long nblk = (total + 255) / 256;
      splitk_epilogue_kernel<T><<<(unsigned)(nblk < 132 * 16 ? nblk : 132 * 16), 256, 0, st>>>(
          sk, bt, tt, rt, ot, h * wd, cout, m_total, used);
      return cudaGetLastError();
    }
  }
  *path = 0;
  const dim3 grid((m_total + FM - 1) / FM, (cout + FN - 1) / FN);
  conv_fma_kernel<T><<<grid, kFmaThreads, 0, st>>>(yt, wt, bt, tt, rt, ot, h, wd, cin, cout,
                                                   m_total);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success).  is_bf16: 1 when x, w, wr,
// bias, time_add, residual, out and y are bfloat16, 0 for float32.  wr,
// time_add and residual may be null.  y: scratch of x's shape and type (the
// normalized input).  scratch: 2 * B * Cin floats (mean, rstd * gamma),
// rounded up to a multiple of 4, then splits * B*H*W * Cout floats when the
// conv splits K.  geometry: null, or the wgmma path's plan (bf16; the
// caller's conv_plan), which then runs or fails; wr is its relaid weight.
// splits: the mma.sync path's split count (at most Cin / 32).  *path
// receives the path taken: 0 FMA, 1 mma.sync, 2 wgmma.  chunks, gps, vec,
// partial, tickets: the statistics' launch grid and persistent workspace
// (gn_stats.cuh).  The caller checks shapes (cin % groups == 0).
extern "C" int ldm_gn_silu_conv3x3(const void* x, const void* gamma, const void* beta,
                                   const void* w, const void* wr, const void* bias,
                                   const void* time_add, const void* residual, void* out,
                                   void* y, void* scratch, void* partial, void* tickets, int b,
                                   int h, int wd, int cin, int cout, int groups, int chunks,
                                   int gps, int vec, int splits, float eps, int is_bf16,
                                   const int* geometry, int* path, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* s = static_cast<float*>(scratch);
  float* p = static_cast<float*>(partial);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaError_t err =
      is_bf16 ? run<bf16>(x, g, be, w, wr, bias, time_add, residual, out, y, s, p, t, b, h, wd,
                          cin, cout, groups, chunks, gps, vec, splits, eps, geometry, path, st)
              : run<float>(x, g, be, w, wr, bias, time_add, residual, out, y, s, p, t, b, h, wd,
                           cin, cout, groups, chunks, gps, vec, splits, eps, nullptr, path, st);
  return static_cast<int>(err);
}
