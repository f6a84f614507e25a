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
// This is the simple kernel that is right first; wgmma, TMA and K5's
// expert-grouped persistent walk are later work.
//
//  * dx: one block owns (bundle, row tile, 128 columns of d_in) and walks
//    d_out.  w is read through its transpose inside the kernel: a column
//    tile of w^T is a band of rows of w[e_b], which lie contiguous along
//    d_out, the reduction axis, so the band lands in shared memory as the
//    K-major B operand that mma.sync wants and no transposed copy of w is
//    made (at dbrx-132b that copy would be 2.1 GB of bfloat16 a weight).
//  * dw: one block owns (expert, 128 rows of d_in, 128 columns of d_out) and
//    walks every row of every bundle of its expert in a fixed order: the
//    bundles as the CSR schedule lists them (by expert, then in bundle
//    order), each bundle's rows in order.  The schedule is one int32 buffer
//    [ptr (E + 1) | ids (nb)]: expert e's bundles are ids[ptr[e]:ptr[e+1]].
//    Each output tile has one writer that sums in fp32 and stores once in
//    x's dtype; an expert with no bundle gets zeros.  No atomics: two runs
//    are bit-identical.
//  * bfloat16: mma.sync m16n8k16 with fp32 accumulators, 32-deep slices
//    through a 4-stage ring of 8-byte cp.async copies (a row of a width
//    that is a multiple of 4 but not of 8 is only 8-byte aligned), the
//    fragments by ldmatrix: plain for dx's row-major dy and K-major w,
//    transposed for dw, where x and dy both lie with the reduction axis
//    (the bundle's rows) slowest.  Rows past cap read as zeros.
//  * float32: IEEE FMAs, a 64 x 64 tile of 256 threads, 4 x 4 outputs a
//    thread, 16-deep slices in shared memory with the next slice's loads in
//    registers while the FMAs run.
//
// d_in and d_out must be multiples of 4 and the operands 16-byte aligned
// (the wrapper checks), as for K5's forward.
//
// C entry points: plain C interfaces for ctypes; each returns the first CUDA
// error of an attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

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
// bfloat16 dx: dx[b] (cap x d_in) = dy[b] (cap x d_out) @ w[e_b]^T
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
// bfloat16 dw: dw[e] (d_in x d_out) = sum over e's bundles of x[b]^T @ dy[b]
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
// float32, 1 = bfloat16 (dy, w and dx alike).  The caller has checked
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
