// The backward of the capacity-bundled expert GEMM (kernel K5) for Hopper,
// sm_90a.  Forward:
//
//   out[b] = x[b] @ w[e_b]        x: (nb, cap, d_in)  w: (E, d_in, d_out)
//
// and against the cotangent dy (nb, cap, d_out):
//
//   dx[b] = dy[b] @ w[e_b]^T                     (nb, cap, d_in)
//   dw[e] = sum over the bundles b with e_b = e of x[b]^T @ dy[b]
//                                                (E, d_in, d_out), zeros
//                                                where no bundle meets e
//
// It replaces no Pallas kernel: the reference trains its MoE layers through
// XLA's autodiff of the expert einsums (src/repro/models/moe.py:313-317 and
// expert_swiglu at :203-212), and the Pallas kernel moe_gemm
// (src/repro/kernels/moe_gemm.py:43) has no backward.  It is here because
// the port's forward runs K5 on the card, and a gradient through it needs a
// kernel of its own.
//
// Bound on an H100: each entry is 2 * nb * cap * d_in * d_out FLOP, as K5's
// forward; at dbrx-132b's training bundles (32 bundles of cap 320, d_model
// 6144, d_ff_expert 10752) 1.353 TFLOP an entry, bound by operations in
// bfloat16 (1.37 ms at the dense peak), against its operands read once.
//
// Every output element has one writer that sums in a fixed order and stores
// once in x's dtype; no route splits the reduction or uses atomics, so two
// runs are bit-identical.  The routes, picked by the wrapper from the dtype
// and the widths (kernels/moe_gemm.py, bwd_route):
//
//  * bfloat16, d_in and d_out multiples of 8 (TMA's 16-byte row strides):
//    moe_bwd_tma_kernel, K5's forward tile route turned round on the
//    machinery of moe_tma.cuh (the header it shares with csrc/moe_gemm.cu):
//    TMA boxes of 64 x 64 with the 128-byte swizzle into a 4-stage ring, one
//    producer warp, two consumer warpgroups on wgmma m64n256k16, persistent
//    blocks.  dx reads w through its transpose with no copy (a box of w's
//    rows is K-major B as it lands) and walks the forward's expert-grouped
//    units; dw takes x^T and dy both MN-major and owns (expert, 128 x 256)
//    tiles, each walking its expert's bundles in the CSR order of
//    bwd_schedule.  Every cap takes it: at cap <= 32 (decode-sized bundles)
//    both entries are bound by bytes (dx by reading w, dw by writing it),
//    and the TMA ring moves them at least as fast as the cp.async kernels
//    below (chip_smoke.py phase 39 times both at cap 8 and 24).
//  * bfloat16, d_in or d_out not a multiple of 8 (a row of d % 8 == 4 is
//    only 8-byte aligned): mma.sync m16n8k16 with fp32 accumulators, 32-deep
//    slices through a 4-stage ring of 8-byte cp.async copies, the fragments
//    by ldmatrix (transposed for dw).  dx: one block per (bundle, row tile,
//    128 columns of d_in), reading w's rows K-major; dw: one block per
//    (expert, 128 x 128 tile) walking its bundles' rows in CSR order.
//  * float32: IEEE FMAs (the 1e-5 limit rules out one-pass TF32), a 64 x 64
//    tile of 256 threads, 4 x 4 outputs a thread, 16-deep slices in shared
//    memory with the next slice's loads in registers while the FMAs run.
//
// Rows past cap read as zeros.  d_in and d_out must be multiples of 4 and
// the operands 16-byte aligned (the wrapper checks), as for K5's forward.
//
// C entry points: plain C interfaces for ctypes; each returns the first CUDA
// error of a tensor-map encode (kEncodeFailed + its CUresult), an attribute
// call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdio>

#include "common.cuh"
#include "moe_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int STAGES = 4;  // the bfloat16 kernels' cp.async ring
constexpr int BK = 32;     // the bfloat16 kernels' slice depth
constexpr int BN = 128;    // output columns of a bfloat16 tile

// 8-byte global -> shared copy, zero-filled when `full` is false.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// Warp layout of a BM x BN tile: WM x WN warps, each MT m16 by NT n8 tiles
// (NT even: ldmatrix x4 gives two n8 tiles at once).
template <int BM>
struct Warps {
  static constexpr int WM = BM >= 64 ? 2 : 1;
  static constexpr int WN = 8 / WM;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static_assert(NT % 2 == 0, "ldmatrix x4 loads n8 tiles in pairs");
};

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// ---------------------------------------------------------------------------
// bfloat16 dx on mma.sync (d_in or d_out not a multiple of 8):
// dx[b] (cap x d_in) = dy[b] (cap x d_out) @ w[e_b]^T
// ---------------------------------------------------------------------------

template <int BM>
struct DxShape {
  static constexpr int LD = BK + 8;  // padded row: 80 bytes
  static constexpr int stage_elems = (BM + BN) * LD;
  static constexpr int smem_bytes = STAGES * stage_elems * 2;
};

template <int BM>
__global__ void __launch_bounds__(kThreads)
moe_bwd_dx_bf16_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                       const int* __restrict__ bundle_expert, int cap,
                       int d_in, int d_out, bf16* __restrict__ dx) {
  using S = DxShape<BM>;
  using L = Warps<BM>;
  constexpr int LD = S::LD, MT = L::MT, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * BM;  // rows of the bundle
  const int col0 = blockIdx.y * BN;  // columns of dx: rows of w[e]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m_base = (warp / L::WN) * (BM / L::WM);
  const int n_base = (warp % L::WN) * (BN / L::WN);
  const bf16* DY = dy + static_cast<long long>(b) * cap * d_out;
  const bf16* W = w + static_cast<long long>(bundle_expert[b]) * d_in * d_out;
  const int n_it = (d_out + BK - 1) / BK;

  auto load_slice = [&](int i, int stage) {
    bf16* as = smem + stage * S::stage_elems;  // [BM][LD]: dy rows, k along
    bf16* bs = as + BM * LD;                   // [BN][LD]: w rows, k along
    const int k0 = i * BK;
    for (int e = tid; e < BM * BK / 4; e += kThreads) {
      const int r = e / (BK / 4);
      const int kc = (e % (BK / 4)) * 4;
      const bool in = row0 + r < cap && k0 + kc < d_out;
      cp_async8(as + r * LD + kc,
                in ? DY + static_cast<long long>(row0 + r) * d_out + k0 + kc : DY,
                in);
    }
    for (int e = tid; e < BN * BK / 4; e += kThreads) {
      const int n = e / (BK / 4);
      const int kc = (e % (BK / 4)) * 4;
      const bool in = col0 + n < d_in && k0 + kc < d_out;
      cp_async8(bs + n * LD + kc,
                in ? W + static_cast<long long>(col0 + n) * d_out + k0 + kc : W,
                in);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lr = lane % 8, lm = lane / 8;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_slice(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<STAGES - 2>();  // slice i has landed
    __syncthreads();              // ... for every thread; slice i - 1 is done
    if (i + STAGES - 1 < n_it) load_slice(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* as = smem + (i % STAGES) * S::stage_elems;
    const bf16* bs = as + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A (m16 x k16, row-major): matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], smem_addr(as + (m_base + mt * 16 + lr + (lm % 2) * 8) * LD +
                                     kk + (lm / 2) * 8));
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // B (k16 x n8, K-major rows of w): matrices (n 0-7, k 0-7), (n 0-7,
        // k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        uint32_t bq[4];
        ldmatrix_x4(bq, smem_addr(bs + (n_base + nt * 8 + lr + (lm / 2) * 8) * LD +
                                  kk + (lm % 2) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], bq[0], bq[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* DX = dx + static_cast<long long>(b) * cap * d_in;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + m_base + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + n_base + nt * 8 + 2 * t4;  // even: c < d_in => c + 1 < d_in
      if (c >= d_in) continue;
      if (r < cap)
        store_bf16x2(DX + static_cast<long long>(r) * d_in + c, acc[mt][nt][0],
                     acc[mt][nt][1]);
      if (r + 8 < cap)
        store_bf16x2(DX + static_cast<long long>(r + 8) * d_in + c,
                     acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 dw on mma.sync (d_in or d_out not a multiple of 8):
// dw[e] (d_in x d_out) = sum over e's bundles of x[b]^T @ dy[b]
// ---------------------------------------------------------------------------

struct DwShape {
  static constexpr int BM = 128;      // rows of dw (d_in)
  static constexpr int LD = BN + 8;   // padded row of a slice: 272 bytes
  static constexpr int stage_elems = 2 * BK * LD;
  static constexpr int smem_bytes = STAGES * stage_elems * 2;
};

__global__ void __launch_bounds__(kThreads)
moe_bwd_dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       const int* __restrict__ sched, int n_experts, int cap,
                       int d_in, int d_out, bf16* __restrict__ dw) {
  using S = DwShape;
  using L = Warps<S::BM>;
  constexpr int BM = S::BM, LD = S::LD, MT = L::MT, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;  // rows of dw[e]: columns of x
  const int n0 = blockIdx.y * BN;  // columns of dw[e]: columns of dy
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m_base = (warp / L::WN) * (BM / L::WM);
  const int n_base = (warp % L::WN) * (BN / L::WN);
  const int* ids = sched + n_experts + 1;
  const int first = sched[e];
  const int per_bundle = (cap + BK - 1) / BK;  // slices a bundle
  const int n_it = (sched[e + 1] - first) * per_bundle;

  auto load_slice = [&](int i, int stage) {
    bf16* xs = smem + stage * S::stage_elems;  // [BK][LD]: x rows, m along
    bf16* ds = xs + BK * LD;                   // [BK][LD]: dy rows, n along
    const long long bundle = ids[first + i / per_bundle];
    const int k0 = (i % per_bundle) * BK;
    const bf16* X = x + bundle * cap * d_in;
    const bf16* DY = dy + bundle * cap * d_out;
    for (int q = tid; q < BK * BM / 4; q += kThreads) {
      const int k = q / (BM / 4);
      const int mc = (q % (BM / 4)) * 4;
      const bool in = k0 + k < cap && m0 + mc < d_in;
      cp_async8(xs + k * LD + mc,
                in ? X + static_cast<long long>(k0 + k) * d_in + m0 + mc : X, in);
    }
    for (int q = tid; q < BK * BN / 4; q += kThreads) {
      const int k = q / (BN / 4);
      const int nc = (q % (BN / 4)) * 4;
      const bool in = k0 + k < cap && n0 + nc < d_out;
      cp_async8(ds + k * LD + nc,
                in ? DY + static_cast<long long>(k0 + k) * d_out + n0 + nc : DY,
                in);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int lr = lane % 8, lm = lane / 8;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) load_slice(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_it) load_slice(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* xs = smem + (i % STAGES) * S::stage_elems;
    const bf16* ds = xs + BK * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = x^T (m16 x k16) from x's [k][m] rows, transposed: matrices
      // (m 0-7 | 8-15) x (k 0-7 | 8-15) as a0..a3 want them
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(a[mt], smem_addr(xs + (kk + lr + (lm / 2) * 8) * LD +
                                           m_base + mt * 16 + (lm % 2) * 8));
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // B = dy (k16 x n8) from dy's [k][n] rows, transposed: matrices
        // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, smem_addr(ds + (kk + lr + (lm % 2) * 8) * LD +
                                        n_base + nt * 8 + (lm / 2) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], bq[0], bq[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* DW = dw + static_cast<long long>(e) * d_in * d_out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = m0 + m_base + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = n0 + n_base + nt * 8 + 2 * t4;  // even: c < d_out => c + 1 < d_out
      if (c >= d_out) continue;
      if (r < d_in)
        store_bf16x2(DW + static_cast<long long>(r) * d_out + c, acc[mt][nt][0],
                     acc[mt][nt][1]);
      if (r + 8 < d_in)
        store_bf16x2(DW + static_cast<long long>(r + 8) * d_out + c,
                     acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: IEEE FMAs on 64 x 64 tiles
// ---------------------------------------------------------------------------

constexpr int FT = 64;       // tile rows and columns
constexpr int FK = 16;       // slice depth
constexpr int FLD = FT + 4;  // padded smem row (floats): 272 bytes

// The slices both float32 kernels stage: A^T and B as [FK][FLD] rows, the
// output's rows (A's) and columns (B's) along each.  Each thread holds one
// float4 of each slice in registers until it stores it.
struct F32Slice {
  float4 a, b;
};

__device__ __forceinline__ float4 load4(const float* p, bool in) {
  return in ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// 16 FMAs a thread a k: rows ty * 4 + i, columns tx * 4 + j of the tile
__device__ __forceinline__ void fma_slice(const float (*as)[FLD],
                                          const float (*bs)[FLD], int ty,
                                          int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < FK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dx[b] = dy[b] @ w[e_b]^T: both operands lie K-major (d_out along each
// row), so each thread loads 4 k of one row and stores them down a column.
__global__ void __launch_bounds__(kThreads)
moe_bwd_dx_f32_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                      const int* __restrict__ bundle_expert, int cap, int d_in,
                      int d_out, float* __restrict__ dx) {
  __shared__ __align__(16) float as[FK][FLD];
  __shared__ __align__(16) float bs[FK][FLD];
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * FT, col0 = blockIdx.y * FT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* DY = dy + static_cast<long long>(b) * cap * d_out;
  const float* W = w + static_cast<long long>(bundle_expert[b]) * d_in * d_out;
  const int lrow = tid / 4, lk = (tid % 4) * 4;  // this thread's loads
  auto load = [&](int k0) {
    const bool kin = k0 + lk < d_out;
    return F32Slice{
        load4(DY + static_cast<long long>(row0 + lrow) * d_out + k0 + lk,
              kin && row0 + lrow < cap),
        load4(W + static_cast<long long>(col0 + lrow) * d_out + k0 + lk,
              kin && col0 + lrow < d_in)};
  };
  float acc[4][4] = {};
  F32Slice next = load(0);
  for (int k0 = 0; k0 < d_out; k0 += FK) {
    __syncthreads();  // the last slice's readers are done
    const float av[4] = {next.a.x, next.a.y, next.a.z, next.a.w};
    const float bv[4] = {next.b.x, next.b.y, next.b.z, next.b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      as[lk + j][lrow] = av[j];
      bs[lk + j][lrow] = bv[j];
    }
    __syncthreads();
    if (k0 + FK < d_out) next = load(k0 + FK);
    fma_slice(as, bs, ty, tx, acc);
  }
  float* DX = dx + static_cast<long long>(b) * cap * d_in;
  const int c = col0 + tx * 4;
  if (c >= d_in) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < cap)
      *reinterpret_cast<float4*>(DX + static_cast<long long>(r) * d_in + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// dw[e] = sum over e's bundles of x[b]^T @ dy[b]: both operands lie with
// the reduction axis slowest, so a slice's rows are copied as they are.
__global__ void __launch_bounds__(kThreads)
moe_bwd_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const int* __restrict__ sched, int n_experts, int cap,
                      int d_in, int d_out, float* __restrict__ dw) {
  __shared__ __align__(16) float as[FK][FLD];
  __shared__ __align__(16) float bs[FK][FLD];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * FT, n0 = blockIdx.y * FT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int* ids = sched + n_experts + 1;
  const int first = sched[e];
  const int per_bundle = (cap + FK - 1) / FK;
  const int n_it = (sched[e + 1] - first) * per_bundle;
  const int lk = tid / 16, lc = (tid % 16) * 4;  // this thread's loads
  auto load = [&](int i) {
    const long long bundle = ids[first + i / per_bundle];
    const int k = (i % per_bundle) * FK + lk;
    const bool kin = k < cap;
    return F32Slice{
        load4(x + (bundle * cap + k) * d_in + m0 + lc, kin && m0 + lc < d_in),
        load4(dy + (bundle * cap + k) * d_out + n0 + lc, kin && n0 + lc < d_out)};
  };
  float acc[4][4] = {};
  F32Slice next{};
  if (n_it) next = load(0);
  for (int i = 0; i < n_it; ++i) {
    __syncthreads();
    *reinterpret_cast<float4*>(&as[lk][lc]) = next.a;
    *reinterpret_cast<float4*>(&bs[lk][lc]) = next.b;
    __syncthreads();
    if (i + 1 < n_it) next = load(i + 1);
    fma_slice(as, bs, ty, tx, acc);
  }
  float* DW = dw + static_cast<long long>(e) * d_in * d_out;
  const int c = n0 + tx * 4;
  if (c >= d_out) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r < d_in)
      *reinterpret_cast<float4*>(DW + static_cast<long long>(r) * d_out + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on TMA and wgmma (d_in and d_out multiples of 8)
// ---------------------------------------------------------------------------

// K5's forward tile route (moe_gemm_tma_kernel) with its operands turned
// round: one producer warp keeps a 4-stage ring of 64-deep slices full
// behind mbarriers, two consumer warpgroups of 64 output rows each run wgmma
// m64n256k16 with the fp32 sums in registers, persistent blocks take work
// items t = blockIdx.x, + gridDim.x, ...  A stage holds two 64 x 64 boxes of
// A (one a warpgroup) and four of B (256 output columns), each 8 KiB with
// the 128-byte swizzle.  Each consumer warp's results leave through a 16 x
// 64 tile of shared memory in 16-byte stores, 8 lanes to 128 contiguous
// bytes of a row (the accumulators' own layout would store 16 bytes a row).
//  * DW false, dx: A = dy[b] (row tiles of 64, K-major: d_out along a row),
//    B = w[e_b]^T: a box of w (64 d_out x 64 d_in rows) is 64 rows of B that
//    are K-major as they land, so four boxes of consecutive d_in rows are
//    B's 256 columns and wgmma reads B K-major (TB = 0) where the forward
//    reads it MN-major.  The items are the forward's expert-grouped units
//    (Walk over pack_schedule's buffer): two 64-row tiles of one expert's
//    bundles by 256 columns of d_in, walking d_out.
//  * DW true, dw: A = x[b]^T, a box of x (64 d_in x 64 rows) MN-major (TA =
//    1); B = dy[b], boxes of 64 d_out x 64 rows MN-major (TB = 1), exactly as
//    the forward reads w.  An item is (expert, 128 rows of d_in, 256 columns
//    of d_out), experts outermost, then d_in tiles: the blocks in flight
//    share the expert's x and dy through L2.  The reduction walks the
//    expert's bundles in the CSR order of `sched` ([ptr (E + 1) | ids]) and
//    each bundle's rows in 64-deep slices; TMA zero-fills rows past cap.  An
//    expert with no bundle has no slice: its tiles are stored as zeros.
constexpr int kTmaThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int kTmaStages = 4;
constexpr int kBox = 64 * 64 * 2;               // one 64 x 64 box: 8 KiB
constexpr int kStage = 2 * kBox + 4 * kBox;     // A: 2 boxes, B: 4 boxes
// each consumer warp's epilogue tile: 16 rows x 64 columns, rows padded by
// 16 bytes (the fragments' 4-byte stores and the 16-byte reads both meet
// every bank once)
constexpr int kEpiLd = 64 + 8;
constexpr int kEpiBytes = 8 * 16 * kEpiLd * 2;
constexpr int kTmaSmem =
    kTmaStages * kStage + 2 * kTmaStages * 8 + kEpiBytes + 1024;
constexpr int kTmaCols = 256;                   // output columns of an item

template <bool DW>
__global__ void __launch_bounds__(kTmaThreads, 1)
moe_bwd_tma_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const int* __restrict__ sched, int nb, int groups, int cap,
                   int d_in, int d_out, long long n_items,
                   bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = smem + kTmaStages * kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTmaStages + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // dx: the forward's walk, d_in in column tiles; dw: (expert, d_in tile,
  // d_out tile), `groups` experts
  Walk walk{sched, sched + nb, sched + 2 * nb, groups, (cap + 63) / 64, 2,
            (d_in + kTmaCols - 1) / kTmaCols};
  const int per = (cap + 63) / 64;                 // dw: slices a bundle
  const int n_m = (d_in + 127) / 128, n_n = (d_out + kTmaCols - 1) / kTmaCols;
  const int* ids = sched + groups + 1;             // dw: bundles by expert

  // dw's item t: expert, first d_in row, first d_out column, its first
  // bundle in ids and its slices
  struct DwItem { int e, m0, n0, first, n_k; };
  auto dw_item = [&](long long t) {
    DwItem it;
    it.e = static_cast<int>(t / (n_m * n_n));
    const int r = static_cast<int>(t % (n_m * n_n));
    it.m0 = (r / n_n) * 128;
    it.n0 = (r % n_n) * kTmaCols;
    it.first = sched[it.e];
    it.n_k = (sched[it.e + 1] - it.first) * per;
    return it;
  };

  if (tid >= 256) {
    // producer: one thread keeps the ring full
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (long long t = blockIdx.x; t < n_items; t += gridDim.x) {
        if constexpr (DW) {
          const DwItem it = dw_item(t);
          for (int k = 0; k < it.n_k; ++k) {
            mbar_wait(empty(stage), phase ^ 1);
            const uint32_t st = smem + stage * kStage;
            const int bundle = ids[it.first + k / per];
            const int row = 64 * (k % per);
            mbar_expect_tx(full(stage), kStage);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              tma_load_3d(st + i * kBox, &ta, it.m0 + 64 * i, row, bundle,
                          full(stage));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load_3d(st + 2 * kBox + j * kBox, &tb, it.n0 + 64 * j, row,
                          bundle, full(stage));
            if (++stage == kTmaStages) stage = 0, phase ^= 1;
          }
        } else {
          if (!walk.seek(t)) break;
          const Item it = item_at(walk, t);
          for (int k = 0; k < (d_out + 63) / 64; ++k) {
            mbar_wait(empty(stage), phase ^ 1);
            const uint32_t st = smem + stage * kStage;
            mbar_expect_tx(full(stage), it.n_slots * kBox + 4 * kBox);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (i < it.n_slots)
                tma_load_3d(st + i * kBox, &ta, 64 * k, 64 * it.tile[i],
                            it.bundle[i], full(stage));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load_3d(st + 2 * kBox + j * kBox, &tb, 64 * k,
                          it.col * kTmaCols + 64 * j, it.expert, full(stage));
            if (++stage == kTmaStages) stage = 0, phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
    return;
  }

  // consumers: warpgroup wg owns output rows 64 wg .. of the item
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  bf16* epi = reinterpret_cast<bf16*>(smem_raw + (smem - smem_addr(smem_raw)) +
                                      kTmaStages * kStage + 2 * kTmaStages * 8) +
              (tid / 32) * 16 * kEpiLd;
  float acc[128];
  int stage = 0, phase = 0;
  for (long long t = blockIdx.x; t < n_items; t += gridDim.x) {
    int n_k, r, c0, rows, cols;
    long long o_off;
    bool live;
    if constexpr (DW) {
      const DwItem it = dw_item(t);
      n_k = it.n_k;
      r = it.m0 + 64 * wg;                  // rows of dw[e]: d_in
      c0 = it.n0;
      rows = d_in;
      cols = d_out;
      o_off = static_cast<long long>(it.e) * d_in * d_out;
      live = r < d_in;
    } else {
      if (!walk.seek(t)) break;
      const Item it = item_at(walk, t);
      n_k = (d_out + 63) / 64;
      r = 64 * it.tile[wg];                 // rows of dx[b]: the bundle's
      c0 = it.col * kTmaCols;
      rows = cap;
      cols = d_in;
      o_off = static_cast<long long>(it.bundle[wg]) * cap * d_in;
      live = wg < it.n_slots;
    }
    if (n_k == 0) {  // dw of an expert with no bundle
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
    }
    int prev = 0;
    for (int k = 0; k < n_k; ++k) {
      mbar_wait(full(stage), phase);
      if (live) {
        const uint32_t st = smem + stage * kStage;
        fence_operand(acc);
        wgmma_fence();
        if constexpr (DW) {
          // A and B MN-major: 16 deep is 16 rows of 128 bytes, +2048 bytes
          const uint64_t da = desc_sw128(st + wg * kBox, 8192, 1024);
          const uint64_t db = desc_sw128(st + 2 * kBox, 8192, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_n256<1, 1>(acc, da + 128 * kk, db + 128 * kk,
                                  (k | kk) != 0);
        } else {
          // A and B K-major: 16 deep is 32 bytes along a swizzled row
          const uint64_t da = desc_sw128(st + wg * kBox, 16, 1024);
          const uint64_t db = desc_sw128(st + 2 * kBox, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_n256<0, 0>(acc, da + 2 * kk, db + 2 * kk,
                                  (k | kk) != 0);
        }
        wgmma_commit();
        fence_operand(acc);
        wgmma_wait<1>();  // slice k - 1's products are done
      }
      if (k > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == kTmaStages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();  // on every path: without rows nothing is outstanding
    fence_operand(acc);
    if (n_k > 0 && lane == 0) mbar_arrive(empty(prev));
    if (!live) continue;

    // acc: warp `warp` holds rows 16 warp + lane / 4 (+ 8) of the warpgroup's
    // 64, columns 8 j + 2 (lane % 4) (+ 1) in acc[4 j .. 4 j + 3].  Each 64
    // columns go through the warp's epilogue tile and out in 16-byte stores,
    // 8 lanes a row: a warp's store writes 4 rows of 128 bytes.
    const int row0 = r + 16 * warp;
    bf16* O = out + o_off;
#pragma unroll
    for (int q4 = 0; q4 < kTmaCols / 64; ++q4) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q4 + jj;
        bf16* e = epi + (lane / 4) * kEpiLd + 8 * jj + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(e) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(e + 8 * kEpiLd) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int rr = 4 * it + lane / 8;
        const int c = c0 + 64 * q4 + 8 * (lane % 8);  // cols % 8 == 0
        if (row0 + rr < rows && c < cols)
          *reinterpret_cast<uint4*>(O + static_cast<long long>(row0 + rr) * cols + c) =
              *reinterpret_cast<const uint4*>(epi + rr * kEpiLd + 8 * (lane % 8));
      }
      __syncwarp();  // the tile is read before the next 64 columns land
    }
  }
}

template <bool DW>
int launch_tma(const CUtensorMap& ta, const CUtensorMap& tb, const int* sched,
               int nb, int groups, int cap, int d_in, int d_out,
               long long n_items, void* out, cudaStream_t stream, int device) {
  static_assert(kTmaSmem <= 232448, "above the 227 KiB a block may use");
  int sms = 0;
  int err = sm_count(device, &sms);
  if (err) return err;
  auto* kernel = moe_bwd_tma_kernel<DW>;
  static std::atomic<int> smem_set[64];
  cudaError_t e = allow_smem(smem_set, kernel, kTmaSmem, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_items == 0) return 0;
  const int grid = static_cast<int>(std::min<long long>(n_items, sms));
  kernel<<<grid, kTmaThreads, kTmaSmem, stream>>>(
      ta, tb, sched, nb, groups, cap, d_in, d_out, n_items,
      static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int BM>
int launch_dx_bf16(const bf16* dy, const bf16* w, const int* be, int nb,
                   int cap, int d_in, int d_out, bf16* dx, cudaStream_t s,
                   int device) {
  constexpr int bytes = DxShape<BM>::smem_bytes;
  auto* kernel = moe_bwd_dx_bf16_kernel<BM>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cap + BM - 1) / BM, (d_in + BN - 1) / BN, nb);
  kernel<<<grid, kThreads, bytes, s>>>(dy, w, be, cap, d_in, d_out, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches dx = dy @ w[e_b]^T on `stream`: dy (nb, cap, d_out), w (E, d_in,
// d_out), dx (nb, cap, d_in); bundle_expert (nb,) on the card; dtype 0 =
// float32, 1 = bfloat16 on mma.sync (dy, w and dx alike).  The caller has checked
// dtypes, shapes (nb <= 65535, cap >= 1, d_in and d_out multiples of 4),
// 16-byte alignment, contiguity and the expert ids.
int moe_gemm_bwd_dx(const void* dy, const void* w, const int* bundle_expert,
                    int nb, int cap, int d_in, int d_out, int dtype, void* dx,
                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((cap + FT - 1) / FT, (d_in + FT - 1) / FT, nb);
    moe_bwd_dx_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w),
        bundle_expert, cap, d_in, d_out, static_cast<float*>(dx));
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* dyb = static_cast<const bf16*>(dy);
  const auto* wb = static_cast<const bf16*>(w);
  auto* dxb = static_cast<bf16*>(dx);
  if (cap <= 16) return launch_dx_bf16<16>(dyb, wb, bundle_expert, nb, cap, d_in, d_out, dxb, s, device);
  if (cap <= 32) return launch_dx_bf16<32>(dyb, wb, bundle_expert, nb, cap, d_in, d_out, dxb, s, device);
  if (cap <= 64) return launch_dx_bf16<64>(dyb, wb, bundle_expert, nb, cap, d_in, d_out, dxb, s, device);
  return launch_dx_bf16<128>(dyb, wb, bundle_expert, nb, cap, d_in, d_out, dxb, s, device);
}

// Launches dw[e] = sum over e's bundles of x[b]^T @ dy[b] on `stream`: x
// (nb, cap, d_in), dy (nb, cap, d_out), dw (n_experts, d_in, d_out), every
// element written (zeros for an expert with no bundle); `sched` the CSR
// [ptr (n_experts + 1) | ids (nb)] on the card.  dtype as above.  The caller
// has checked what moe_gemm_bwd_dx's has, and n_experts <= 65535.
int moe_gemm_bwd_dw(const void* x, const void* dy, const int* sched,
                    int n_experts, int cap, int d_in, int d_out, int dtype,
                    void* dw, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((d_in + FT - 1) / FT, (d_out + FT - 1) / FT, n_experts);
    moe_bwd_dw_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), sched,
        n_experts, cap, d_in, d_out, static_cast<float*>(dw));
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = DwShape::smem_bytes;
  static std::atomic<int> smem_set[64];
  err = allow_smem(smem_set, moe_bwd_dw_bf16_kernel, bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((d_in + DwShape::BM - 1) / DwShape::BM, (d_out + BN - 1) / BN,
                  n_experts);
  moe_bwd_dw_bf16_kernel<<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), sched,
      n_experts, cap, d_in, d_out, static_cast<bf16*>(dw));
  return static_cast<int>(cudaGetLastError());
}

// Launches dx = dy @ w[e_b]^T in bfloat16 on TMA and wgmma on `stream`: dy
// (nb, cap, d_out), w (n_experts, d_in, d_out), dx (nb, cap, d_in);
// `sched` is K5's forward schedule buffer (moe_tma.cuh, above Walk) with
// n_groups groups and n_units units of its tile route.  d_in and d_out are
// multiples of 8 and the operands 16-byte aligned (the caller has checked).
int moe_gemm_bwd_dx_tma(const void* dy, const void* w, const int* sched,
                        int nb, int n_groups, int cap, int d_in, int d_out,
                        int n_experts, long long n_units, void* dx,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb;
  int e = bf16_map(&ta, dy, d_out, cap, nb, 64, 64);
  if (!e) e = bf16_map(&tb, w, d_out, d_in, n_experts, 64, 64);
  if (e) return e;
  return launch_tma<false>(ta, tb, sched, nb, n_groups, cap, d_in, d_out,
                           n_units * ((d_in + kTmaCols - 1) / kTmaCols), dx,
                           static_cast<cudaStream_t>(stream), device);
}

// Launches dw[e] = sum over e's bundles of x[b]^T @ dy[b] in bfloat16 on TMA
// and wgmma on `stream`, every element written (zeros for an expert with no
// bundle): x (nb, cap, d_in), dy (nb, cap, d_out), dw (n_experts, d_in,
// d_out); `sched` the CSR [ptr (n_experts + 1) | ids (nb)].  Widths and
// alignment as moe_gemm_bwd_dx_tma's.
int moe_gemm_bwd_dw_tma(const void* x, const void* dy, const int* sched,
                        int nb, int n_experts, int cap, int d_in, int d_out,
                        void* dw, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tb;
  int e = bf16_map(&ta, x, d_in, cap, nb, 64, 64);
  if (!e) e = bf16_map(&tb, dy, d_out, cap, nb, 64, 64);
  if (e) return e;
  const long long n_items = static_cast<long long>(n_experts) *
                            ((d_in + 127) / 128) *
                            ((d_out + kTmaCols - 1) / kTmaCols);
  return launch_tma<true>(ta, tb, sched, nb, n_experts, cap, d_in, d_out,
                          n_items, dw, static_cast<cudaStream_t>(stream),
                          device);
}

const char* repro_cuda_error_string(int err) {
  if (err >= kEncodeFailed) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kEncodeFailed);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
