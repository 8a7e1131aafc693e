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
// (2 * M * Cout * 9 * Cin operations against about M * (Cin + 2 * Cout) bytes)
// are far above the card's operations-per-byte ratio, so the product runs on
// the int8 tensor cores.
//
// Design: implicit GEMM, M = B*H*W rows (pixels), N = Cout, K = 9 * Cin.
// A 64 x 64 output tile per block of 4 warps (each 32 x 32: 2 m16 x 4 n8
// tiles), mma.sync m16n8k32 s8 with s32 accumulators in registers.  Each
// k-step takes 32 input channels of one tap (Cin % 32 == 0): the A tile is 64
// pixel rows of the shifted image, loaded with cp.async whose zero-fill
// supplies the SAME border (a row whose shifted pixel leaves its image reads
// nothing), and the B tile 64 output channels' 32 weights.  A 4-stage
// cp.async ring overlaps loads with the products; rows of 48 bytes keep
// ldmatrix free of bank conflicts.  The epilogue applies the f32
// dequantization per (row, co) with explicit round-to-nearest operations in
// the plain version's order, so the output equals it exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace ldm;

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LD = BK + 16;  // smem row stride in bytes
constexpr int kStages = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
s8_conv3x3_kernel(const int8_t* __restrict__ y8, const float* __restrict__ sa,
                  const int8_t* __restrict__ w8, const float* __restrict__ ws,
                  const float* __restrict__ bias, const T* __restrict__ time_add,
                  const T* __restrict__ residual, T* __restrict__ out, int h, int w, int cin,
                  int cout, int m_total) {
  __shared__ __align__(16) int8_t as[kStages][BM * LD];
  __shared__ __align__(16) int8_t bs[kStages][BN * LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = h * w;
  const long k_total = 9L * cin;
  const int k_steps = 9 * cin / BK;
  const int steps_per_tap = cin / BK;

  // Each thread copies one 16-byte chunk of A and one of B per stage:
  // row tid / 2, bytes (tid % 2) * 16.
  const int lrow = tid / 2, lchunk = (tid % 2) * 16;
  const int am = m0 + lrow;
  const bool a_row_ok = am < m_total;
  const int a_img = a_row_ok ? am / hw : 0;
  const int a_rem = a_row_ok ? am % hw : 0;
  const int a_y = a_rem / w, a_x = a_rem % w;
  const int bco = n0 + lrow;
  const bool b_row_ok = bco < cout;
  const int8_t* b_src = w8 + (b_row_ok ? (long)bco * k_total : 0) + lchunk;

  auto load_stage = [&](int stage, int ks) {
    const int tap = ks / steps_per_tap;
    const int ci0 = (ks % steps_per_tap) * BK;
    const int yy = a_y + tap / 3 - 1, xx = a_x + tap % 3 - 1;
    const bool ok = a_row_ok && yy >= 0 && yy < h && xx >= 0 && xx < w;
    const int8_t* a_src =
        y8 + (ok ? ((long)a_img * hw + (long)yy * w + xx) * cin + ci0 + lchunk : 0);
    cp_async16(&as[stage][lrow * LD + lchunk], a_src, ok);
    cp_async16(&bs[stage][lrow * LD + lchunk], b_src + (b_row_ok ? (long)ks * BK : 0), b_row_ok);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage ks has landed; every warp is done with ks - 1
    const int next = ks + kStages - 1;
    if (next < k_steps) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* a_t = as[ks % kStages];
    const int8_t* b_t = bs[ks % kStages];
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
  cp_async_wait<0>();

  // Epilogue: element e of tile (i, j) is row g + 8 * (e / 2), column
  // 2 * t4 + (e & 1) of the 16 x 8 tile.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * r;
      if (m >= m_total) continue;
      const int img = m / hw;
      const float s_img = sa[img];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int co = n0 + wn * 32 + j * 8 + 2 * t4 + c;
          if (co >= cout) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * r + c]), __fmul_rn(s_img, ws[co]));
          v = __fadd_rn(v, bias[co]);
          if (time_add) v = __fadd_rn(v, to_f32(time_add[(long)img * cout + co]));
          if (residual) v = __fadd_rn(v, to_f32(residual[(long)m * cout + co]));
          out[(long)m * cout + co] = from_f32<T>(v);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* y8, const void* sa, const void* w8, const void* ws,
                   const void* bias, const void* time_add, const void* residual, void* out,
                   int b, int h, int w, int cin, int cout, cudaStream_t st) {
  const int m_total = b * h * w;
  const dim3 grid((m_total + BM - 1) / BM, (cout + BN - 1) / BN);
  s8_conv3x3_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(y8), static_cast<const float*>(sa),
      static_cast<const int8_t*>(w8), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const T*>(time_add),
      static_cast<const T*>(residual), static_cast<T*>(out), h, w, cin, cout, m_total);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success).  out_bf16: 1 when out,
// time_add and residual are bfloat16, 0 for float32.  time_add and residual
// may be null.  The caller checks shapes (cin % 32 == 0, 16-byte aligned
// y8 and w8).
extern "C" int ldm_s8_conv3x3(const void* y8, const void* sa, const void* w8, const void* ws,
                              const void* bias, const void* time_add, const void* residual,
                              void* out, int b, int h, int w, int cin, int cout, int out_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_bf16 ? launch<bf16>(y8, sa, w8, ws, bias, time_add, residual, out, b, h, w, cin, cout, st)
               : launch<float>(y8, sa, w8, ws, bias, time_add, residual, out, b, h, w, cin, cout,
                               st);
  return static_cast<int>(err);
}
