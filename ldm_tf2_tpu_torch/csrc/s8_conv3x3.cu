// int8 3x3 SAME convolution (stride 1) with the W8A8 dequantization epilogue,
// for Hopper (sm_90a):
//
//   out[m, co] = acc[m, co] * (sa[b(m)] * ws[co]) + bias[co]
//                (+ time_add[b(m), co]) (+ residual[m, co])
//   acc[m, co] = sum over taps (dy, dx) and ci of y8[pixel m + (dy, dx), ci] * w8[co, tap, ci]
//
// with s8 x s8 -> s32 products, the result cast to the output type.
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/quant_conv.py::_batched_conv_kernel
// (an s8 3x3 conv over every image's rows stacked as [B*HW, Cin], with
// per-image tap masks and this epilogue), and, launched right after
// gn_silu_quant.cu, the second half of _chain_kernel (the whole int8
// ResBlock chain in one TPU call).  The TPU fuses the chain to avoid layout
// copies at custom-call boundaries; the card has no such copies, and the s8
// slab between the two launches costs one write and one read of B*HW*Cin
// bytes.
//
// Layout: y8 [B, H, W, Cin] int8 (NHWC); w8 [Cout, 3, 3, Cin] int8 (OHWI, so
// each output channel's K = 9 * Cin values are contiguous, tap-major); sa [B],
// ws [Cout], bias [Cout] float32; time_add [B, Cout] and residual
// [B, H, W, Cout] in the output type.
//
// What bounds it on this card: at the serving shapes the integer products
// (2 * M * Cout * 9 * Cin operations against about M * (Cin + 2 * Cout) +
// 9 * Cin * Cout bytes) are far above the card's operations-per-byte ratio,
// so the product runs on the int8 tensor cores; at the 8x8 level (M = 512)
// the 7-30 MB of weights come close.
//
// Design (geometry from the wrapper's s8_conv_plan): implicit GEMM, M =
// B*H*W rows (pixels), N = Cout, K = 9 * Cin, for Cin % 32 == 0, Cout % 8
// == 0 and 16-byte aligned y8 and w8 (every int8 chain of the U-Net).  A
// CTA owns a BM x BN output tile and a range of k-steps, a k-step being one
// tap and 128 input channels (one 128-byte swizzled row of s8; where Cin is
// not a multiple of 128, as at 320 and 960, the last chunk's channels past
// Cin are zero-filled by TMA in both operands: 20% and 6.7% more products
// than those shapes need).  BM: one or two consumer warpgroups of one or
// two 64-row sub-tiles each (64 rows at M <= 64, 256 at 128 < M <= 512,
// else 128); BN = 160 (divides Cout = 320, 640, 1280) or 128 (where a
// warpgroup holds two sub-tiles).  A producer warp issues TMA loads into a
// ring of stages signalled by mbarriers: the A tile is one box {128
// channels, bw, bh, bb} of a 4-D map over y8 (bw * bh * bb = BM pixels:
// whole rows, and whole images where they fit), loaded at coordinates
// shifted by the tap, so TMA's zero fill of everything outside the tensor,
// negative coordinates included, is exactly the SAME border; the B tile is
// one box {128, 1, BN} of a map over w8 viewed as [Cout, 9, Cin], which is
// K-major as stored (no relayout).  Both are read by s8 SS wgmma
// m64nBNk32, four k-steps of 32 channels per stage, into s32 accumulators
// in registers; the products of stage j run while stage j - 1's are
// retired and its slot refilled.  Where the output has too few tiles to
// fill the card (the 16x16 and 8x8 levels) the k-steps are split over
// blockIdx.z, each split writing its exact s32 partial sums to its own
// slot; a second launch adds them in split order (exact integers: any
// order gives the same sum) and applies the epilogue.  At M <= 512 every M
// tile reads all weights, which stay in L2 (at most 30 MB), so each weight
// byte comes from HBM about once per call.  The f32 dequantization runs per
// (row, co) with explicit round-to-nearest operations in the plain
// version's order, so the output equals it exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;

// out = acc * (sa[img] * ws[co]) + bias[co] (+ time_add) (+ residual), each
// operation rounded to nearest in float32 in the plain version's order.
template <typename T>
__device__ __forceinline__ T dequant(int acc, float s_img, const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     const T* __restrict__ time_add,
                                     const T* __restrict__ residual, int img, long m, int co,
                                     int cout) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(s_img, ws[co]));
  v = __fadd_rn(v, bias[co]);
  if (time_add) v = __fadd_rn(v, to_f32(time_add[(long)img * cout + co]));
  if (residual) v = __fadd_rn(v, to_f32(residual[m * cout + co]));
  return from_f32<T>(v);
}

// Grid (M tiles, N tiles, splits).  M tile t covers pixels x0 .. x0 + bw,
// y0 .. y0 + bh of images b0 .. b0 + bb; split z reduces k-steps
// [z * per_split, min((z + 1) * per_split, k_total)), k-step it being tap
// it % 9 of channels 128 * (it / 9) ...  partial: null when there is one
// split (the epilogue runs here), else [splits, M, Cout] s32.
template <typename T, int NWG, int MT, int BN_, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
s8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap, const float* __restrict__ sa,
                     const float* __restrict__ ws, const float* __restrict__ bias,
                     const T* __restrict__ time_add, const T* __restrict__ residual,
                     T* __restrict__ out, int* __restrict__ partial, int b, int h, int wd,
                     int cout, int bw, int bh, int bb, int tiles_x, int tiles_y, int k_total,
                     int per_split) {
  using C = hopper::ConvTiles<NWG, MT, BN_, STAGES>;
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
  const int n0 = blockIdx.y * BN_;
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
        tma_load_4d(a, &amap, &full[st], (it / 9) * 128, x0 + tap % 3 - 1, y0 + tap / 3 - 1,
                    b0);
        tma_load_4d(a + C::A_BYTES, &bmap, &full[st], (it / 9) * 128, tap, n0, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows 64 (MT wg + mt) .. + 63, mt < MT
  const int wg = warp / 4;
  int acc[MT][BN_ / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN_ / 2; ++i) acc[mt][i] = 0;
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
        WgmmaS8SS<BN_>::run(acc[mt], desc_kmajor(a, C::BM, (wg * MT + mt) * 64, kk),
                            desc_kmajor(bt, BN_, 0, kk), 1);
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
      const float s_img = partial == nullptr ? sa[img] : 0.f;
#pragma unroll
      for (int j = 0; j < BN_ / 8; ++j) {
        const int co = n0 + 8 * j + 2 * t4;
        if (co >= cout) continue;
        const int v0 = acc[mt][4 * j + 2 * half], v1 = acc[mt][4 * j + 2 * half + 1];
        if (partial != nullptr) {
          *reinterpret_cast<int2*>(partial + ((long)blockIdx.z * m_total + m) * cout + co) =
              make_int2(v0, v1);
        } else {
          out[m * cout + co] =
              dequant<T>(v0, s_img, ws, bias, time_add, residual, img, m, co, cout);
          out[m * cout + co + 1] =
              dequant<T>(v1, s_img, ws, bias, time_add, residual, img, m, co + 1, cout);
        }
      }
    }
  }
}

// The second launch of a split conv: out = dequant(sum of the splits' s32
// partials, in split order).
template <typename T>
__global__ void __launch_bounds__(256)
s8_splitk_epilogue_kernel(const int* __restrict__ partial, const float* __restrict__ sa,
                          const float* __restrict__ ws, const float* __restrict__ bias,
                          const T* __restrict__ time_add, const T* __restrict__ residual,
                          T* __restrict__ out, int hw, int cout, int m_total, int splits) {
  const long total = (long)m_total * cout;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    int v = 0;
    for (int z = 0; z < splits; ++z) v += partial[z * total + i];
    const long m = i / cout;
    const int img = (int)(m / hw);
    out[i] = dequant<T>(v, sa[img], ws, bias, time_add, residual, img, m, (int)(i % cout), cout);
  }
}

template <typename T, int NWG, int MT, int BN_, int STAGES>
cudaError_t launch_wgmma(const int8_t* y8, const float* sa, const int8_t* w8, const float* ws,
                         const float* bias, const T* time_add, const T* residual, T* out,
                         int* partial, int b, int h, int wd, int cin, int cout, const int* geo,
                         cudaStream_t st) {
  using C = hopper::ConvTiles<NWG, MT, BN_, STAGES>;
  const int bw = geo[4], bh = geo[5], bb = geo[6], per_split = geo[7];
  CUtensorMap am, bm;
  cudaError_t err = hopper::make_s8_map(&am, y8, {cin, wd, h, b}, {128, bw, bh, bb});
  if (err == cudaSuccess) err = hopper::make_s8_map(&bm, w8, {cin, 9, cout, 1}, {128, 1, BN_, 1});
  if (err != cudaSuccess) return err;
  auto kernel = s8_conv_wgmma_kernel<T, NWG, MT, BN_, STAGES>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int tiles_x = (wd + bw - 1) / bw, tiles_y = (h + bh - 1) / bh;
  const int tiles_b = (b + bb - 1) / bb;
  const int k_total = 9 * ((cin + 127) / 128);
  const int splits = (k_total + per_split - 1) / per_split;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(tiles_x * tiles_y * tiles_b, (cout + BN_ - 1) / BN_, splits);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(am, bm, sa, ws, bias, time_add, residual, out,
                                           splits > 1 ? partial : nullptr, b, h, wd, cout, bw,
                                           bh, bb, tiles_x, tiles_y, k_total, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int m_total = b * h * wd;
  const long total = (long)m_total * cout;
  const long nblk = (total + 255) / 256;
  s8_splitk_epilogue_kernel<T><<<(unsigned)(nblk < 132 * 16 ? nblk : 132 * 16), 256, 0, st>>>(
      partial, sa, ws, bias, time_add, residual, out, h * wd, cout, m_total, splits);
  return cudaGetLastError();
}

// The instantiations: ops/quant_conv.py's CONV_WGMMA_STAGES.
template <typename T>
cudaError_t dispatch_wgmma(const int8_t* y8, const float* sa, const int8_t* w8, const float* ws,
                           const float* bias, const T* time_add, const T* residual, T* out,
                           int* partial, int b, int h, int wd, int cin, int cout, const int* geo,
                           cudaStream_t st) {
#define LDM_S8CONV(...)                                                                   \
  if (hopper::conv_geometry_is<__VA_ARGS__>(geo))                                         \
    return launch_wgmma<T, __VA_ARGS__>(y8, sa, w8, ws, bias, time_add, residual, out,     \
                                        partial, b, h, wd, cin, cout, geo, st)
  LDM_S8CONV(1, 1, 128, 8);
  LDM_S8CONV(1, 1, 160, 8);
  LDM_S8CONV(2, 1, 128, 7);
  LDM_S8CONV(2, 1, 160, 6);
  LDM_S8CONV(2, 2, 128, 4);
  return cudaErrorInvalidValue;
#undef LDM_S8CONV
}

template <typename T>
cudaError_t run(const void* y8, const void* sa, const void* w8, const void* ws,
                const void* bias, const void* time_add, const void* residual, void* out,
                void* partial, int b, int h, int w, int cin, int cout, const int* geometry,
                cudaStream_t st) {
  if (geometry == nullptr || cin % 32 != 0 || cout % 8 != 0 || !aligned16(y8) || !aligned16(w8))
    return cudaErrorInvalidValue;
  return dispatch_wgmma<T>(static_cast<const int8_t*>(y8), static_cast<const float*>(sa),
                           static_cast<const int8_t*>(w8), static_cast<const float*>(ws),
                           static_cast<const float*>(bias), static_cast<const T*>(time_add),
                           static_cast<const T*>(residual), static_cast<T*>(out),
                           static_cast<int*>(partial), b, h, w, cin, cout, geometry, st);
}

}  // namespace

// Returns a cudaError_t value (0 on success).  out_bf16: 1 when out,
// time_add and residual are bfloat16, 0 for float32.  time_add and residual
// may be null.  geometry: the caller's s8_conv_plan (cin % 32 == 0, cout %
// 8 == 0, 16-byte aligned y8 and w8), which runs or fails.  partial:
// [splits, B*H*W, Cout] int32 scratch when the plan splits K, else null.
extern "C" int ldm_s8_conv3x3(const void* y8, const void* sa, const void* w8, const void* ws,
                              const void* bias, const void* time_add, const void* residual,
                              void* out, void* partial, int b, int h, int w, int cin, int cout,
                              int out_bf16, const int* geometry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_bf16 ? run<bf16>(y8, sa, w8, ws, bias, time_add, residual, out, partial, b, h, w, cin,
                           cout, geometry, st)
               : run<float>(y8, sa, w8, ws, bias, time_add, residual, out, partial, b, h, w,
                            cin, cout, geometry, st);
  return static_cast<int>(err);
}
