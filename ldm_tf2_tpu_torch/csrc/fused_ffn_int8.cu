// W8A8 transformer FFN for Hopper (sm_90a):
//   y   = LayerNorm(x)                       f32 statistics, fast variance clamped at 0
//   sy  = max(max_j |y|, 1e-8) * (1/127)     per row;  y8 = clip(rint(y * (1/sy)), +-127)
//   a   = f32(i32(y8 . w1v8)) * (sy * s1v) + b1v,   g likewise with w1g8, s1g, b1g
//   u   = a * gelu_poly(g)                   f32, the JAX package's polynomial GELU
//   su  = max(max_j |u|, 1e-8) * (1/127)     per row, over the whole hidden row F
//   u8  = clip(rint(u * (1/su)), +-127)
//   out = ((T(f32(i32(u8 . w28)) * (su * s2)) + b2) + x)   each add in x's type T
//
// Replaces the TPU kernel ldm_tf2_tpu/ops/fused_ffn.py::_ffn_kernel_int8
// (reached there through _pallas_ffn_int8, which no path of the JAX package
// dispatches).  The weights are quantized per column once, outside the
// kernel (ops/fused_ffn.py::quantize_ffn_weights), and stored transposed so
// that each output column's K values are contiguous: w1v8, w1g8 [F, d],
// w28 [d, F], int8, with float32 scales s1v, s1g [F] and s2 [d].  Both
// products' operands are therefore K-major as stored, as s8 wgmma needs.
//
// What bounds it on this card: 6 * M * d * F integer operations against
// about M * d activation bytes and 3 * d * F weight bytes, so at the U-Net's
// shapes it is bound by operations, s8 at 1,979 TOP/s.
//
// The trouble is the row scale su: it needs the whole hidden row of F
// values before any of them can be quantized, and a 64-row tile of f32 u
// (64 x F x 4 bytes: 320 KB at d = 320, 1.3 MB at d = 1280) does not fit in
// one CTA's shared memory, where a TPU VMEM tile holds it.  The design is
// one launch on thread-block clusters (geometry from ops/fused_ffn.py::
// ffn8_plan, checked here by geometry_ok): a cluster of c CTAs owns a 64-row
// tile, and rank r owns `tpr` hidden tiles of 64 columns (value and gate of
// a tile are one s8 m64n128k32 wgmma).  Grid (c * ceil(M / 64)), cluster
// (c); per CTA one producer warp and two consumer warpgroups.
//  1. LN: rank r takes the tile's rows r, r + c, ... (a warp up to four at a
//     time; the sums in double), and writes their codes into every rank's
//     y8 through distributed shared memory, laid out as a TMA box would lay
//     them (128-byte swizzle, K-major chunks of 128 k-values, k past d
//     zero), and sy likewise.
//  2. Up-projection: the producer streams the rank's w1v8 and w1g8 tiles
//     (TMA boxes {128 k, 64 rows}, zero-filled past d and F) through an
//     mbarrier ring, half of its slots for each warpgroup; the warpgroups
//     take alternate hidden tiles, run s8 SS wgmma (A: y8 resident) into s32
//     and the GEGLU on the accumulator registers, keep u in float32 (shared
//     memory, or where the plan says it does not fit, a workspace in device
//     memory: "spill") and the running row max of |u|.
//  3. Row scale: each rank publishes its 64 partial maxima; after a cluster
//     barrier every rank reads all c of them in rank order.  A max is exact
//     in any order, so su is the plain version's.
//  4. Each warpgroup quantizes its own u to u8 and writes it to a u8 [M, F]
//     workspace in device memory (64 x F / c bytes a CTA; L2 holds it).
//  5. Down-projection, route (b): after a cluster barrier, rank r computes
//     output tiles r, r + c, ... of 80 columns over the full K = F.  The
//     producer streams, per 128-wide K chunk, a TMA box of u8 {128 k, 64
//     rows} (the other ranks' columns too) and one of w28 {128 k, 80 rows}
//     through 18 KB slots laid over the ring and the dead y8; s8 SS wgmma
//     m64n80k32.  The two warpgroups take alternate chunks; each then
//     finishes half the tile's columns, adding the other's s32 sums exactly
//     (integers, any order), and applies su * s2, + b2, + x.  Route (a), s32
//     partials of every output exchanged between ranks, would hold 64 x d x
//     4 bytes (320 KB at d = 1280) per CTA.  Reading the owning rank's u8
//     straight into the wgmma's register fragments (ld.shared::cluster)
//     took twice as long a chunk: distributed shared memory moves far fewer
//     bytes a cycle than TMA from L2.
// No atomics: the result is a function of the inputs and the plan only.
// Rounding follows the plain version (ops/fused_ffn.py::_plain_ffn_int8)
// operation by operation: explicit round-to-nearest multiplies and adds (no
// FMA contraction), rintf for half-to-even codes; only the LayerNorm's
// summation order differs.
//
// What holds it back (globaltimer stamps per phase in a copy of this file,
// H100 SXM): one CTA an SM and 8 consumer warps leave the LN, the GEGLU and
// the epilogues latency-bound, and with 64-row tiles every row tile
// streams all 3 d F weight bytes from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace ldm;
using namespace ldm::hopper;

constexpr int BM = 64;          // rows of a cluster's tile
constexpr int BN = 80;          // output columns of a down tile
constexpr int SLOT = 16384;     // ring slot: up 2 x 64 x 128 B, down 80 x 128 B
constexpr int UP_TX = 2 * 64 * 128;
constexpr int DOWN_A = BM * 128;           // a down stage: 64 rows x 128 k of u8
constexpr int DOWN_TX = DOWN_A + BN * 128;  // and 80 rows x 128 k of w28: 18 KB
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int MAX_DOWN_SLOTS = 12;  // down-projection slots of DOWN_TX bytes
// sy, two partial maxima, published maxima, su; the down slots' barriers
constexpr int SMALL = 5 * BM * 4 + 16 * MAX_DOWN_SLOTS;
constexpr int MAX_SMEM = 232448;
constexpr float kInv127 = 1.0f / 127.0f;

// The launch geometry, in the order of ffn8_plan's C argument.
struct Geometry {
  int cluster;    // c: CTAs per 64-row tile
  int tpr;        // hidden tiles of 64 per rank
  int stages;     // ring slots, half for each warpgroup
  int resident;   // 1: u in shared memory; 0: in the caller's workspace
  int y_bytes;    // y8, later u8
  int u_bytes;    // u (resident), and the warpgroups' s32 exchange
  int smem;       // dynamic shared memory
};

int smem_bytes(const Geometry& g) {
  return 1024 + g.stages * SLOT + g.y_bytes + g.u_bytes + SMALL + 16 * g.stages;
}

bool geometry_ok(const Geometry& g, int d, int f) {
  const int tiles = (f + 63) / 64, nch = (d + 127) / 128;
  const bool c_ok = g.cluster == 1 || g.cluster == 2 || g.cluster == 4 || g.cluster == 8 ||
                    g.cluster == 16;
  return c_ok && g.cluster <= tiles && g.tpr == (tiles + g.cluster - 1) / g.cluster &&
         g.stages >= 2 && g.stages % 2 == 0 && g.y_bytes == BM * nch * 128 &&
         g.u_bytes % 1024 == 0 &&
         g.u_bytes >= BM * BN * 4 && (!g.resident || g.u_bytes >= g.tpr * 16384) &&
         g.smem == smem_bytes(g) && g.smem <= MAX_SMEM;
}

// The JAX package's _GELU_POLY_CS (ops/fused_ffn.py), highest power last:
// gelu(x) = 0.5 x + 0.5 h, h = p(min(|x|, 4)^2) for |x| <= 4, else |x|.
__constant__ float kGeluCs[10] = {
    1.17001125700400e-05f, 7.97724482796235e-01f, -1.32617207955768e-01f,
    1.96232925549133e-02f, -2.22546161701489e-03f, 1.90177605018239e-04f,
    -1.17833702310525e-05f, 4.93687027647959e-07f, -1.23685744320984e-08f,
    1.38723939155963e-10f};

__device__ __forceinline__ uint32_t quant(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// ------------------------------------------------ clusters and DSMEM
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// The shared::cluster address of the local shared address `a` in rank `r`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster_v4(uint32_t a, const uint32_t (&v)[4]) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v[0]),
               "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
// Generic-proxy writes of shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<bf16>(const bf16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = to_f32(h[e]);
}

// T: the type of x, b2 and out; TB: of b1v and b1g (T, or float32).
template <typename T, typename TB>
__global__ void __launch_bounds__(THREADS, 1)
ffn8_kernel(const __grid_constant__ CUtensorMap w1v_map,
            const __grid_constant__ CUtensorMap w1g_map,
            const __grid_constant__ CUtensorMap w28_map,
            const __grid_constant__ CUtensorMap u8_map, const T* __restrict__ x,
            const float* __restrict__ lns, const float* __restrict__ lnb,
            const float* __restrict__ s1v, const TB* __restrict__ b1v,
            const float* __restrict__ s1g, const TB* __restrict__ b1g,
            const float* __restrict__ s2, const T* __restrict__ b2, T* __restrict__ out,
            int8_t* __restrict__ u8g, float* __restrict__ spill, int m, int d, int f,
            float eps, Geometry geo) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ybuf = ring + geo.stages * SLOT;  // y8; with the ring, the down slots
  unsigned char* ubuf = ybuf + geo.y_bytes;        // u (resident), then the s32 exchange
  float* sy = reinterpret_cast<float*>(ubuf + geo.u_bytes);
  float* part = sy + BM;  // [2][64]: each warpgroup's row maxima
  float* pub = part + 2 * BM;
  float* su = pub + BM;
  uint64_t* dfull = reinterpret_cast<uint64_t*>(su + BM);
  uint64_t* dempty = dfull + MAX_DOWN_SLOTS;
  uint64_t* full = dempty + MAX_DOWN_SLOTS;
  uint64_t* empty = full + geo.stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = geo.cluster, rank = cluster_rank();
  const int m0 = (blockIdx.x / c) * BM;
  const int nch = (d + 127) / 128;
  const int tiles = (f + 63) / 64, tpr = geo.tpr, t_begin = rank * tpr;
  const int t_count = max(0, min(tpr, tiles - t_begin));
  const int out_tiles = (d + BN - 1) / BN;
  const int o_count = rank < out_tiles ? (out_tiles - rank + c - 1) / c : 0;
  const int k_chunks = (tiles + 1) / 2;  // down-projection chunks of 128 hidden columns
  // The ring: slots [w * per_wg, (w + 1) * per_wg) serve warpgroup w alone, so
  // each slot's stages are consumed in order by one warpgroup (a parity wait
  // never runs two phases ahead).  The down-projection's slots (DOWN_TX
  // bytes, their own barriers, d_per_wg a warpgroup) fill the ring and the
  // then dead y8.
  const int per_wg = geo.stages / 2;
  const int d_per_wg =
      min(MAX_DOWN_SLOTS, (geo.stages * SLOT + geo.y_bytes) / DOWN_TX) / 2;

  if (tid == 0) {
    for (int i = 0; i < geo.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    for (int i = 0; i < 2 * d_per_wg; ++i) {
      mbar_init(&dfull[i], 1);
      mbar_init(&dempty[i], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // Every rank has started before any writes another's memory: the arrival
  // now, the wait just before a warp's first write to another rank.
  cluster_arrive();

  if (warp == CONSUMERS / 32) {  // producer: lane 0 issues every TMA load
    cluster_wait();
    cluster_arrive();  // y8 published (the producer writes none)
    int next[2] = {0, 0};        // each warpgroup's stages issued so far, per phase
    // the slot of warpgroup w's next stage among `per` a warpgroup, once
    // that warpgroup has freed it
    auto slot_for = [&](int w, int per, uint64_t* freed) {
      const int k = next[w]++, st = w * per + k % per;
      mbar_wait(&freed[st], ((k / per) & 1) ^ 1);
      return st;
    };
    if (lane == 0) {  // up: hidden tiles 2p and 2p + 1, a chunk of each in turn
      for (int p = 0; 2 * p < t_count; ++p)
        for (int kc = 0; kc < nch; ++kc)
          for (int w = 0; w < 2 && 2 * p + w < t_count; ++w) {
            const int st = slot_for(w, per_wg, empty), t = t_begin + 2 * p + w;
            mbar_expect_tx(&full[st], UP_TX);
            tma_load_4d(ring + st * SLOT, &w1v_map, &full[st], kc * 128, t * 64, 0, 0);
            tma_load_4d(ring + st * SLOT + UP_TX / 2, &w1g_map, &full[st], kc * 128, t * 64,
                        0, 0);
          }
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();  // row maxima published
    cluster_wait();
    cluster_arrive();  // u8 in device memory
    cluster_wait();
    if (lane == 0) {  // down: tile i's K chunks to the warpgroups in turn
      next[0] = next[1] = 0;
      for (int o = 0; o < o_count; ++o)
        for (int kc = 0; kc < k_chunks; ++kc) {
          const int st = slot_for(kc % 2, d_per_wg, dempty);
          unsigned char* slot = ring + st * DOWN_TX;
          mbar_expect_tx(&dfull[st], DOWN_TX);
          tma_load_4d(slot, &u8_map, &dfull[st], kc * 128, m0, 0, 0);
          tma_load_4d(slot + DOWN_A, &w28_map, &dfull[st], kc * 128, (rank + o * c) * BN, 0, 0);
        }
    }
    __syncwarp();
    return;
  }

  // ---------------------------------------------------------- 1. LN
  // A lane owns 16-byte units u = lane + 32 i of the row's codes: k-values
  // 16 u .. 16 u + 15, unit u % 8 of 128-k chunk u / 8.  The sums run in
  // double (each x^2 rounded to float first, as the plain version's x * x),
  // so mean and E[x^2] are their sums' correctly rounded quotients.
  const uint32_t ybase = smem_u32(ybuf);
  bool started = false;  // this warp has waited for every rank to start
  // A warp takes R of the rank's rows at a time (idx, idx + 8, ...), their
  // loads and reductions interleaved: as many as keep R x U <= 4, where a
  // lane holds U units of a row.
  auto ln_rows = [&](int idx, auto rows_, auto units_) {
    constexpr int R = decltype(rows_)::value, U = decltype(units_)::value;
    int lr[R];
    float v[R][U][16];
    double s[R], s2[R];
#pragma unroll
    for (int p = 0; p < R; ++p) {
      lr[p] = rank + c * (idx + p * (CONSUMERS / 32));
      s[p] = s2[p] = 0.0;
      const long row = m0 + lr[p];
      const bool live = row < m;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int j = 16 * (lane + 32 * i);
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          if (live && j < d) {
            float q[4];
            load4(x + row * d + j + e, q);
#pragma unroll
            for (int k = 0; k < 4; ++k) v[p][i][e + k] = q[k];
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) v[p][i][e + k] = 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          s[p] += v[p][i][e];
          s2[p] += __fmul_rn(v[p][i][e], v[p][i][e]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int p = 0; p < R; ++p) {
        s[p] += __shfl_xor_sync(0xffffffffu, s[p], off);
        s2[p] += __shfl_xor_sync(0xffffffffu, s2[p], off);
      }
    float mu[R], rstd[R], amax[R];
#pragma unroll
    for (int p = 0; p < R; ++p) {
      mu[p] = static_cast<float>(s[p] / d);
      const float var =
          fmaxf(__fsub_rn(static_cast<float>(s2[p] / d), __fmul_rn(mu[p], mu[p])), 0.0f);
      rstd[p] = 1.0f / sqrtf(__fadd_rn(var, eps));
      amax[p] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int j = 16 * (lane + 32 * i);
      if (j < d) {
        float ga[16], be[16];
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          *reinterpret_cast<float4*>(ga + e) = *reinterpret_cast<const float4*>(lns + j + e);
          *reinterpret_cast<float4*>(be + e) = *reinterpret_cast<const float4*>(lnb + j + e);
        }
#pragma unroll
        for (int p = 0; p < R; ++p)
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            v[p][i][e] = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(v[p][i][e], mu[p]), rstd[p]), ga[e]), be[e]);
            amax[p] = fmaxf(amax[p], fabsf(v[p][i][e]));
          }
      }
    }
    if (!started) cluster_wait();  // the warp's first write to another rank follows
    started = true;
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const float scale = __fmul_rn(fmaxf(warp_max(amax[p]), 1e-8f), kInv127);
      const float inv = 1.0f / scale;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = lane + 32 * i;
        if (u >= nch * 8) break;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (16 * u < d) {
#pragma unroll
          for (int e = 0; e < 16; ++e) w[e / 4] |= quant(v[p][i][e], inv) << (8 * (e % 4));
        }
        // the 128-byte swizzle: unit u % 8 of row lr at (u % 8) ^ (lr % 8)
        const uint32_t off = (u / 8) * (BM * 128) + lr[p] * 128 + (((u ^ lr[p]) & 7) << 4);
        for (int q = 0; q < c; ++q) st_cluster_v4(mapa(ybase + off, q), w);
      }
      if (lane == 0) {
        const uint32_t a = smem_u32(sy + lr[p]);
        for (int q = 0; q < c; ++q) st_cluster(mapa(a, q), __float_as_uint(scale));
      }
    }
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I3 = std::integral_constant<int, 3>;
  using I4 = std::integral_constant<int, 4>;
  const int units = (d + 511) / 512;  // of 16 codes a lane: 80 units at d = 1280
  for (int idx = warp; idx < BM / c;) {  // warp-uniform
    const int left = (BM / c - idx + CONSUMERS / 32 - 1) / (CONSUMERS / 32);
    const int r = min(left >= 4 ? 4 : left >= 2 ? 2 : 1, units == 1 ? 4 : units == 2 ? 2 : 1);
    if (units == 1 && r == 4)
      ln_rows(idx, I4{}, I1{});
    else if (units == 1 && r == 2)
      ln_rows(idx, I2{}, I1{});
    else if (units == 1)
      ln_rows(idx, I1{}, I1{});
    else if (units == 2 && r == 2)
      ln_rows(idx, I2{}, I2{});
    else if (units == 2)
      ln_rows(idx, I1{}, I2{});
    else
      ln_rows(idx, I1{}, I3{});
    idx += r * (CONSUMERS / 32);
  }
  if (!started) cluster_wait();
  fence_proxy_async();
  cluster_arrive();
  cluster_wait();
  fence_proxy_async();

  // ------------------------------------------------- 2. up-projection
  const int wg = warp / 4, tw = tid % 128, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * (warp % 4) + g;  // this thread's rows: r0 and r0 + 8
  float4* ust = reinterpret_cast<float4*>(
      geo.resident ? reinterpret_cast<float*>(ubuf)
                   : spill + (long)blockIdx.x * tpr * (16384 / 4));
  float rmax[2] = {0.f, 0.f};
  int mine = 0;  // this warpgroup's stages consumed so far
  {
    const float sy0 = sy[r0], sy1 = sy[r0 + 8];
    for (int lt = wg; lt < t_count; lt += 2) {
      const int t = t_begin + lt;
      int acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int kc = 0; kc < nch; ++kc, ++mine) {
        const int st = wg * per_wg + mine % per_wg;
        mbar_wait(&full[st], (mine / per_wg) & 1);
        const uint32_t bt = smem_u32(ring + st * SLOT);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaS8SS<128>::run(acc, desc_kmajor(ybase, BM, 0, kc * 4 + kk),
                              desc_kmajor(bt, 128, 0, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[st]);
      }
      // register 4j + e: row r0 + 8 (e / 2), column 8j + 2 t4 + (e % 2): the
      // value for j < 8, the gate of the same hidden column at j + 8.  Half
      // the tile at a time, the polynomial's steps run across its 16
      // elements (independent chains).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float av[16], gv[16], p[16], tq[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int jv = 4 * h + q / 4, e = q % 4;
          const int n = min(t * 64 + 8 * jv + 2 * t4 + (e & 1), f - 1);
          const float syr = e < 2 ? sy0 : sy1;
          av[q] = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * jv + e]), __fmul_rn(syr, s1v[n])),
                            to_f32(b1v[n]));
          gv[q] = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[4 * (jv + 8) + e]), __fmul_rn(syr, s1g[n])),
              to_f32(b1g[n]));
          const float cq = fminf(fabsf(gv[q]), 4.0f);
          tq[q] = __fmul_rn(cq, cq);
          p[q] = kGeluCs[9];
        }
#pragma unroll
        for (int i = 8; i >= 0; --i)
#pragma unroll
          for (int q = 0; q < 16; ++q) p[q] = __fadd_rn(__fmul_rn(p[q], tq[q]), kGeluCs[i]);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          float uq[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 4 * jq + e;
            const float ax = fabsf(gv[q]);
            const float gelu =
                __fadd_rn(__fmul_rn(0.5f, gv[q]), __fmul_rn(0.5f, ax > 4.0f ? ax : p[q]));
            const int n = t * 64 + 8 * (4 * h + jq) + 2 * t4 + (e & 1);
            uq[e] = n < f ? __fmul_rn(av[q], gelu) : 0.f;  // columns past F hold 0
            rmax[e / 2] = fmaxf(rmax[e / 2], fabsf(uq[e]));
          }
          ust[(lt * 8 + 4 * h + jq) * 128 + tw] = make_float4(uq[0], uq[1], uq[2], uq[3]);
        }
      }
    }
  }

  // --------------------------------------------------- 3. row scale
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = rmax[h];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if (t4 == 0) part[wg * BM + r0 + 8 * h] = v;
  }
  named_sync(1, CONSUMERS);
  if (tid < BM) pub[tid] = fmaxf(part[tid], part[BM + tid]);
  cluster_arrive();
  cluster_wait();
  if (tid < BM) {
    const uint32_t a = smem_u32(pub + tid);
    float amax = 0.f;
    for (int q = 0; q < c; ++q) amax = fmaxf(amax, __uint_as_float(ld_cluster(mapa(a, q))));
    su[tid] = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  }
  named_sync(1, CONSUMERS);

  // ------------------------------------------- 4. u8, to device memory
  // [M, F] row-major, which the down-projection's TMA boxes read (rows past
  // M and columns past F are not written: the boxes read them as zeros).
  // A warpgroup quantizes a tile into its staging rows in the (free) ring,
  // then writes them out 16 bytes a thread.
  const float su0 = su[r0], su1 = su[r0 + 8];
  {
    constexpr int ROW = 80;  // staging row bytes: 64 codes, padded against bank conflicts
    unsigned char* stage = ring + wg * BM * ROW;
    const float inv0 = 1.0f / su0, inv1 = 1.0f / su1;
    for (int lt = wg; lt < t_count; lt += 2) {
#pragma unroll
      for (int jv = 0; jv < 8; ++jv) {
        const float4 u = ust[(lt * 8 + jv) * 128 + tw];
        const int col = 8 * jv + 2 * t4;
        *reinterpret_cast<uint16_t*>(stage + r0 * ROW + col) =
            static_cast<uint16_t>(quant(u.x, inv0) | (quant(u.y, inv0) << 8));
        *reinterpret_cast<uint16_t*>(stage + (r0 + 8) * ROW + col) =
            static_cast<uint16_t>(quant(u.z, inv1) | (quant(u.w, inv1) << 8));
      }
      named_sync(4 + wg, 128);
      const int col0 = (t_begin + lt) * 64;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int seg = tw + 128 * i, r = seg / 4, cb = 16 * (seg % 4);
        if (m0 + r < m && col0 + cb < f)
          *reinterpret_cast<uint4*>(u8g + (long)(m0 + r) * f + col0 + cb) =
              *reinterpret_cast<const uint4*>(stage + r * ROW + cb);
      }
      named_sync(4 + wg, 128);  // the staging rows are free again
    }
  }
  fence_proxy_async();  // the generic writes, before the other ranks' TMA reads
  cluster_arrive();
  cluster_wait();

  // ----------------------------------------------- 5. down-projection
  int4* xch = reinterpret_cast<int4*>(ubuf);  // each warpgroup's sums for the other
  int dmine = 0;  // this warpgroup's down stages consumed so far
  for (int o = 0; o < o_count; ++o) {
    const int n0 = (rank + o * c) * BN;
    int acc[40];
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[i] = 0;
    for (int kc = wg; kc < k_chunks; kc += 2, ++dmine) {
      const int st = wg * d_per_wg + dmine % d_per_wg;
      mbar_wait(&dfull[st], (dmine / d_per_wg) & 1);
      const uint32_t at = smem_u32(ring + st * DOWN_TX), bt = at + DOWN_A;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaS8SS<BN>::run(acc, desc_kmajor(at, BM, 0, kk), desc_kmajor(bt, BN, 0, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&dempty[st]);
    }
    // Each warpgroup finishes half the tile's columns, n8 blocks 5 wg ..
    // 5 wg + 4, adding the other's s32 sums for them (exact in any order).
    if (o > 0) named_sync(3, CONSUMERS);  // both have read the last tile's sums
    int fin[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const int4 give = wg == 0 ? make_int4(acc[4 * q + 20], acc[4 * q + 21], acc[4 * q + 22],
                                            acc[4 * q + 23])
                                : make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                            acc[4 * q + 3]);
      xch[(wg * 5 + q) * 128 + tw] = give;
#pragma unroll
      for (int e = 0; e < 4; ++e) fin[4 * q + e] = wg == 0 ? acc[4 * q + e] : acc[4 * q + 20 + e];
    }
    named_sync(2, CONSUMERS);
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const int4 p = xch[((1 - wg) * 5 + q) * 128 + tw];
      fin[4 * q] += p.x, fin[4 * q + 1] += p.y, fin[4 * q + 2] += p.z, fin[4 * q + 3] += p.w;
    }
    if (o + 1 < o_count) named_sync(3, CONSUMERS);
    // the epilogue's operands first (indices clamped; stores masked), then
    // out = ((T(acc * (su * s2)) + b2) + x)
    const int nb = n0 + 40 * wg + 2 * t4;  // + 8 q + (e % 2)
    const long rw0 = min((long)m0 + r0, (long)m - 1), rw1 = min((long)m0 + r0 + 8, (long)m - 1);
    float s2v[10], b2v[10], xv[20];
#pragma unroll
    for (int q = 0; q < 5; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = min(nb + 8 * q + e, d - 1);
        s2v[2 * q + e] = s2[n];
        b2v[2 * q + e] = to_f32(b2[n]);
        xv[4 * q + e] = to_f32(x[rw0 * d + n]);
        xv[4 * q + 2 + e] = to_f32(x[rw1 * d + n]);
      }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long row = m0 + r0 + 8 * (e / 2);
        const int n = nb + 8 * q + (e & 1);
        const float v = __fmul_rn(__int2float_rn(fin[4 * q + e]),
                                  __fmul_rn(e < 2 ? su0 : su1, s2v[2 * q + (e & 1)]));
        const float ob =
            to_f32(from_f32<T>(__fadd_rn(to_f32(from_f32<T>(v)), b2v[2 * q + (e & 1)])));
        if (row < m && n < d) out[row * d + n] = from_f32<T>(__fadd_rn(ob, xv[4 * q + e]));
      }
    }
  }
}

template <typename T, typename TB>
cudaError_t prepare() {
  static bool done = false;  // once per instantiation
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(ffn8_kernel<T, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ffn8_kernel<T, TB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = err == cudaSuccess;
  return err;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

void config(Launch& l, const Geometry& g, int m, cudaStream_t st) {
  l.cfg = cudaLaunchConfig_t{};
  l.cfg.gridDim = dim3(g.cluster * ((m + BM - 1) / BM));
  l.cfg.blockDim = dim3(THREADS);
  l.cfg.dynamicSmemBytes = g.smem;
  l.cfg.stream = st;
  l.attr.id = cudaLaunchAttributeClusterDimension;
  l.attr.val.clusterDim.x = g.cluster;
  l.attr.val.clusterDim.y = 1;
  l.attr.val.clusterDim.z = 1;
  l.cfg.attrs = &l.attr;
  l.cfg.numAttrs = 1;
}

template <typename T, typename TB>
cudaError_t run(const void* x, const float* lns, const float* lnb, const void* w1v8,
                const float* s1v, const void* b1v, const void* w1g8, const float* s1g,
                const void* b1g, const void* w28, const float* s2, const void* b2, void* out,
                void* u8, float* spill, int m, int d, int f, float eps, const Geometry& g,
                cudaStream_t st) {
  if (m < 1 || d % 32 || d > 1280 || f % 32 || !geometry_ok(g, d, f) ||
      (!g.resident && spill == nullptr) || !aligned16(x) || !aligned16(lns) ||
      !aligned16(lnb) || !aligned16(w1v8) || !aligned16(w1g8) || !aligned16(w28) ||
      !aligned16(u8))
    return cudaErrorInvalidValue;
  CUtensorMap w1v_map, w1g_map, w28_map, u8_map;
  cudaError_t err = make_s8_map(&w1v_map, w1v8, {d, f, 1, 1}, {128, 64, 1, 1});
  if (err == cudaSuccess) err = make_s8_map(&w1g_map, w1g8, {d, f, 1, 1}, {128, 64, 1, 1});
  if (err == cudaSuccess) err = make_s8_map(&w28_map, w28, {f, d, 1, 1}, {128, BN, 1, 1});
  if (err == cudaSuccess) err = make_s8_map(&u8_map, u8, {f, m, 1, 1}, {128, BM, 1, 1});
  if (err == cudaSuccess) err = prepare<T, TB>();
  if (err != cudaSuccess) return err;
  Launch l;
  config(l, g, m, st);
  err = cudaLaunchKernelEx(&l.cfg, ffn8_kernel<T, TB>, w1v_map, w1g_map, w28_map, u8_map,
                           static_cast<const T*>(x), lns, lnb, s1v, static_cast<const TB*>(b1v),
                           s1g, static_cast<const TB*>(b1g), s2, static_cast<const T*>(b2),
                           static_cast<T*>(out), static_cast<int8_t*>(u8), spill, m, d, f,
                           eps, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t max_clusters(const Geometry& g, int m, int* out) {
  Launch l;
  config(l, g, m, nullptr);
  cudaError_t err = prepare<T, TB>();
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, ffn8_kernel<T, TB>, &l.cfg);
  return err;
}

Geometry geometry_of(const int* a) {
  return Geometry{a[0], a[1], a[2], a[3], a[4], a[5], a[6]};
}

}  // namespace

// Returns a cudaError_t value (0 on success).  x, b2 and out have the
// activation type (is_bf16: 1 bfloat16, 0 float32); b1v and b1g too where
// bias_bf16 is 1 (with is_bf16 only), else float32; every other operand is
// float32 or int8 as named above.  geometry: the caller's ffn8_plan
// {cluster, tiles per rank, stages, resident, y8 bytes, u bytes, u8 row
// bytes, shared bytes}, which runs or fails.  spill: null where the plan
// keeps u in shared memory, else [clusters * cluster * tiles per rank *
// 4096] float32.  The caller checks shapes (d % 32 == 0, d <= 1280, f % 32
// == 0) and 16-byte alignment of x, lns, lnb and the int8 weights.
extern "C" int ldm_fused_ffn_int8(const void* x, const void* lns, const void* lnb,
                                  const void* w1v8, const void* s1v, const void* b1v,
                                  const void* w1g8, const void* s1g, const void* b1g,
                                  const void* w28, const void* s2, const void* b2, void* out,
                                  void* u8, void* spill, int m, int d, int f, float eps,
                                  int is_bf16,
                                  int bias_bf16, const int* geometry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (geometry == nullptr || (bias_bf16 && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry_of(geometry);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  float* sp = static_cast<float*>(spill);
  auto go = [&](auto launch) {
    return launch(x, f32(lns), f32(lnb), w1v8, f32(s1v), b1v, w1g8, f32(s1g), b1g, w28,
                  f32(s2), b2, out, u8, sp, m, d, f, eps, g, st);
  };
  cudaError_t err = !is_bf16   ? go(run<float, float>)
                    : bias_bf16 ? go(run<bf16, bf16>)
                                : go(run<bf16, float>);
  return static_cast<int>(err);
}

// How many clusters of the geometry the card holds at once (0: the launch
// cannot run); a cudaError_t value.
extern "C" int ldm_fused_ffn_int8_clusters(int m, int is_bf16, int bias_bf16,
                                           const int* geometry, int* out) {
  const Geometry g = geometry_of(geometry);
  const cudaError_t err = !is_bf16   ? max_clusters<float, float>(g, m, out)
                          : bias_bf16 ? max_clusters<bf16, bf16>(g, m, out)
                                      : max_clusters<bf16, float>(g, m, out);
  return static_cast<int>(err);
}
