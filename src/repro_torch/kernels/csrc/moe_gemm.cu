// Capacity-bundled expert GEMM (kernel K5) for Hopper, sm_90a.
//
//   out[b] = x[b] @ w[bundle_expert[b]]     x: (nb, cap, d_in)  w: (E, d_in, d_out)
//
// Replaces the Pallas TPU kernel repro.kernels.moe_gemm.moe_gemm
// (src/repro/kernels/moe_gemm.py:43).  The TPU version prefetches the
// bundle->expert map as a scalar operand and walks d_in as its innermost,
// sequential grid axis with the output tile resident in VMEM.  Here one thread
// block owns one (bundle, cap tile, d_out tile): it reads bundle_expert[b]
// itself, walks d_in, keeps the fp32 accumulators in registers and stores the
// tile once in x's dtype.  The row tile is picked from cap by the caller (16,
// 32, 64 or 128): a decode bundle of 24 rows runs in a 24-row tile of the
// decode kernel, and each block streams its columns of the expert's weights
// once.  Rows past cap and k past d_in load as zeros and are not stored; d_in
// and d_out must be multiples of 4 and the operands 16-byte aligned (the
// wrapper checks).
//
//  * float32, row tiles 64 and 128 (DBRX's prefill: bound by operations):
//    3xTF32 on the tensor cores, CUTLASS's OpMultiplyAddFastF32 idea.  Each
//    fp32 operand is split into big = tf32(x) and small = tf32(x - big) (both
//    rounded to nearest by an integer add and mask) and wgmma m64n128k8 sums
//    small*big + big*small + big*big, the small terms first, which keeps
//    fp32 accuracy at three TF32 products per product.  One warpgroup per 64
//    rows.  Raw fp32 slices (32 deep) stream through a 2-stage cp.async
//    ring; each thread splits the chunks it copied itself (so no barrier
//    sits between landing and splitting) into big and small halves in one of
//    two split buffers, once per block rather than once per warp that reads
//    them, in the 8 x 16-byte core matrices the tensor cores read from shared
//    memory.  TF32 takes B only K-major, so W's [k][n] tiles are transposed
//    as they are split, each thread rotating its 4 x 4 tile so that a warp's
//    stores spread over all banks.  One barrier per slice: slice i + 1 is
//    split while the tensor cores multiply slice i.  The products of each
//    slice are summed from zero and carried into the accumulator with IEEE
//    adds: the tensor cores' own accumulation truncates, and over DBRX's
//    d_in it breaks the MoE layer's 1e-4 limit.  (Built with
//    -DREPRO_K5_NO_CARRY they accumulate in place; scripts/card_studies.py
//    k5-carry builds that variant to measure what the carry buys.)
//  * float32, row tiles 16 and 32 (decode: bound by the bytes of the
//    weights, a stack of 4.2 GB at DBRX): IEEE FMAs, 2 columns a thread, 256
//    a block, each thread streaming its weight rows down d_in with 8 rows in
//    flight ahead of the FMAs and x^T in shared memory.  Tensor-core tiles of
//    128 columns fed through shared memory read the stack at about 1.4 TB/s
//    here, as torch.bmm does; a walk down the rows with the loads in flight
//    reads it at the rate of a plain reduction.
//  * bfloat16, fp32 accumulation and one rounding on store, three routes
//    picked by the wrapper from the shape (kernels/moe_gemm.py, bf16_route):
//    - cap > 32 (DBRX's prefill: bound by operations): TMA loads x as
//      (nb, cap, d_in) and w as (E, d_in, d_out) boxes of 64 x 64 with the
//      128-byte swizzle into a 4-stage ring of 64-deep slices (rows past cap
//      read as zeros); one producer thread keeps the ring full behind
//      mbarriers, two consumer warpgroups run wgmma m64n256k16 with the fp32
//      sums in registers.  For 16-bit types wgmma takes B MN-major, so w's
//      [k][n] boxes feed the tensor cores as they land: no transpose pass,
//      no thread touching an operand.  A block computes a unit of two 64-row
//      tiles of one expert (cap 320 is five such tiles, with none wasted on
//      rows past cap) by 256 columns; persistent blocks walk the
//      expert-grouped schedule (Walk), so an expert's weight columns are
//      read by its units side by side and cross the memory bus about once.
//    - cap <= 32 (decode: bound by the bytes of the weights): A and B
//      swapped, w's 64-column boxes as wgmma's A (MN-major) and x^T as its
//      B (m64n32k16: up to 32 rows of the bundles that meet one expert), two
//      boxes a slice (256 contiguous bytes of each weight row), a 5-stage
//      ring, two blocks an SM; the expert-grouped walk reads each weight
//      column once for all the bundles that meet its expert.
//    - d_in or d_out not a multiple of 8 (TMA needs 16-byte row strides):
//      mma.sync m16n8k16 on the raw slices (32 deep, 4-stage ring of 8-byte
//      cp.async copies: a bfloat16 row of d_in % 8 == 4 elements is only
//      8-byte aligned).
//    No route splits d_in or uses atomics: each output is summed in one
//    fixed order, so two calls are bit-identical.
//
// C entry points: plain C interfaces for ctypes; each returns the first CUDA
// error of an attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdio>

#include "common.cuh"
#include "moe_tma.cuh"

namespace {

constexpr int BN = 128;      // output columns of a tensor-core tile
constexpr int kThreads = 256;  // the bfloat16 kernel's block
constexpr int STAGES = 4;      // the bfloat16 kernel's cp.async ring
#ifdef REPRO_K5_NO_CARRY
constexpr bool kCarry = false;
#else
constexpr bool kCarry = true;  // float32 wgmma: carry each slice's sum
#endif

// 8-byte global -> shared copy, zero-filled when `full` is false.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// float32, row tiles of 16 and 32: IEEE FMAs over streamed weight rows
// ---------------------------------------------------------------------------

// RM rows (cap rounded up to 8), 2 columns a thread, 128 threads: a block
// owns 256 columns of one bundle and walks d_in, each thread keeping kU rows
// of its weights in flight ahead of the FMAs; x^T goes through shared memory
// in KC-deep chunks.
constexpr int kRowsThreads = 128;
constexpr int kRowsCols = 2 * kRowsThreads;
constexpr int kU = 8;    // weight rows a thread has in flight
constexpr int KC = 256;  // k depth of one x chunk

template <int RM>
__global__ void __launch_bounds__(kRowsThreads)
moe_gemm_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ bundle_expert, int cap, int d_in,
                     int d_out, float* __restrict__ out) {
  __shared__ __align__(16) float xs[KC][RM];  // x^T of one chunk
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kRowsCols + 2 * tid;  // even: col < d_out => col + 1 < d_out
  const bool live = col < d_out;
  const float* X = x + static_cast<long long>(b) * cap * d_in;
  const float* W = w + static_cast<long long>(bundle_expert[b]) * d_in * d_out +
                   (live ? col : 0);

  float acc[RM][2];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r][0] = acc[r][1] = 0.0f;

  for (int k0 = 0; k0 < d_in; k0 += KC) {
    const int kn = min(KC, d_in - k0);
    __syncthreads();  // the last chunk's readers are done
    // lanes along the rows, so that the transposed stores hit distinct banks
    for (int e = tid; e < RM * KC / 4; e += kRowsThreads) {
      const int r = e % RM;
      const int kq = 4 * (e / RM);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < cap && kq < kn)
        v = *reinterpret_cast<const float4*>(X + static_cast<long long>(r) * d_in + k0 + kq);
      xs[kq][r] = v.x;
      xs[kq + 1][r] = v.y;
      xs[kq + 2][r] = v.z;
      xs[kq + 3][r] = v.w;
    }
    __syncthreads();
    float2 wn[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      wn[u] = live && u < kn
                  ? *reinterpret_cast<const float2*>(W + static_cast<long long>(k0 + u) * d_out)
                  : make_float2(0.0f, 0.0f);
    for (int kk = 0; kk < kn; kk += kU) {
      float2 wc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        wc[u] = wn[u];
        const int kf = kk + kU + u;  // the next group's rows, loaded now
        wn[u] = live && kf < kn
                    ? *reinterpret_cast<const float2*>(W + static_cast<long long>(k0 + kf) * d_out)
                    : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (kk + u >= kn) break;
#pragma unroll
        for (int r4 = 0; r4 < RM; r4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[kk + u][r4]);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[r4 + i][0] = fmaf(xr[i], wc[u].x, acc[r4 + i][0]);
            acc[r4 + i][1] = fmaf(xr[i], wc[u].y, acc[r4 + i][1]);
          }
        }
      }
    }
  }

  if (!live) return;
  float* O = out + static_cast<long long>(b) * cap * d_out + col;
#pragma unroll
  for (int r = 0; r < RM; ++r)
    if (r < cap)
      *reinterpret_cast<float2*>(O + static_cast<long long>(r) * d_out) =
          make_float2(acc[r][0], acc[r][1]);
}

// ---------------------------------------------------------------------------
// float32, row tiles of 64 and 128: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

// BM = 64 WGS rows (one warpgroup of 128 threads per 64 rows) x BN columns,
// 32-deep slices.  Shared memory: two split buffers, each A big and small
// (BM x 32 TF32) and B big and small (BN x 32 TF32, W transposed: wgmma
// takes TF32 only K-major), in 8 x 4 core matrices; then the raw ring.
template <int WGS>
struct WgShape {
  static constexpr int BM = 64 * WGS;
  static constexpr int BK = 32;
  static constexpr int threads = 128 * WGS;
  static constexpr int STAGES = 2;
  static constexpr int LDXR = BK + 4;                    // raw X row (floats)
  static constexpr int raw_floats = BM * LDXR + BK * BN;
  static constexpr int a_words = BM * BK;                // one half of A
  static constexpr int b_words = BN * BK;                // one half of B
  static constexpr int split_words = 2 * a_words + 2 * b_words;
  static constexpr int smem_bytes = 2 * split_words * 4 + STAGES * raw_floats * 4;
  static constexpr uint32_t LBO = 128;                   // next 4 k
  static constexpr uint32_t SBO = BK / 4 * 128;          // next 8 rows
};

template <int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
moe_gemm_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ bundle_expert, int cap, int d_in,
                      int d_out, float* __restrict__ out) {
  using S = WgShape<WGS>;
  constexpr int BM = S::BM, BK = S::BK, LDXR = S::LDXR, STAGES = S::STAGES;
  constexpr int NT = S::threads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint32_t* split = reinterpret_cast<uint32_t*>(smem_raw);        // [2]
  float* raw = reinterpret_cast<float*>(split + 2 * S::split_words);  // [STAGES]

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const float* X = x + static_cast<long long>(b) * cap * d_in;
  const float* W = w + static_cast<long long>(bundle_expert[b]) * d_in * d_out;
  const int n_it = (d_in + BK - 1) / BK;

  // Each thread copies, and later splits, the same pieces of every slice:
  // X chunks e = tid + NT i (16 bytes: row r, k 4 kc..), placed so that the
  // 32 lanes of a warp cover 8 rows x 4 chunks; W tiles of 4 k x 4 n
  // (n4 = tau % 32, k quad kq = tau / 32).
  auto x_chunk = [&](int e, int& r, int& kc) {
    const int g32 = e / 32;
    r = 8 * (g32 % (BM / 8)) + e % 8;
    kc = 4 * (g32 / (BM / 8)) + (e / 8) % 4;
  };
  auto load_slice = [&](int i) {
    float* xs = raw + (i % STAGES) * S::raw_floats;
    float* ws = xs + BM * LDXR;
    const int k0 = i * BK;
#pragma unroll
    for (int e = tid; e < BM * BK / 4; e += NT) {
      int r, kc;
      x_chunk(e, r, kc);
      const int k = k0 + 4 * kc;
      const bool in = row0 + r < cap && k < d_in;
      cp_async16(xs + r * LDXR + 4 * kc,
                 in ? X + static_cast<long long>(row0 + r) * d_in + k : X, in);
    }
#pragma unroll
    for (int tau = tid; tau < BK * BN / 16; tau += NT) {
      const int n = col0 + 4 * (tau % (BN / 4));
      const int kq = tau / (BN / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * kq + j;
        const bool in = k < d_in && n < d_out;
        cp_async16(ws + (4 * kq + j) * BN + n - col0,
                   in ? W + static_cast<long long>(k) * d_out + n : W, in);
      }
    }
  };
  auto split_slice = [&](int i) {
    const float* xs = raw + (i % STAGES) * S::raw_floats;
    const float* ws = xs + BM * LDXR;
    uint32_t* a_big = split + (i & 1) * S::split_words;
    uint32_t* a_small = a_big + S::a_words;
    uint32_t* b_big = a_small + S::a_words;
    uint32_t* b_small = b_big + S::b_words;
#pragma unroll
    for (int e = tid; e < BM * BK / 4; e += NT) {
      int r, kc;
      x_chunk(e, r, kc);
      const float4 v = *reinterpret_cast<const float4*>(xs + r * LDXR + 4 * kc);
      const uint2 p0 = split_tf32(v.x), p1 = split_tf32(v.y);
      const uint2 p2 = split_tf32(v.z), p3 = split_tf32(v.w);
      const int off = core_word<BK>(r, 4 * kc);
      *reinterpret_cast<uint4*>(a_big + off) = make_uint4(p0.x, p1.x, p2.x, p3.x);
      *reinterpret_cast<uint4*>(a_small + off) = make_uint4(p0.y, p1.y, p2.y, p3.y);
    }
#pragma unroll
    for (int tau = tid; tau < BK * BN / 16; tau += NT) {
      const int n4 = tau % (BN / 4);
      const int kq = tau / (BN / 4);
      // rotate by n4 / 2 so that the lanes of a warp store to all 8 rows of
      // a core matrix at each step
      const int rot = (n4 >> 1) & 3;
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = rotate4(*reinterpret_cast<const float4*>(ws + (4 * kq + j) * BN + 4 * n4), rot);
      const float* vf = reinterpret_cast<const float*>(v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = 4 * n4 + ((q + rot) & 3);
        const uint2 p0 = split_tf32(vf[q]), p1 = split_tf32(vf[4 + q]);
        const uint2 p2 = split_tf32(vf[8 + q]), p3 = split_tf32(vf[12 + q]);
        const int off = core_word<BK>(n, 4 * kq);
        *reinterpret_cast<uint4*>(b_big + off) = make_uint4(p0.x, p1.x, p2.x, p3.x);
        *reinterpret_cast<uint4*>(b_small + off) = make_uint4(p0.y, p1.y, p2.y, p3.y);
      }
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n_it) load_slice(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // this thread's pieces of slice 0
  split_slice(0);
  if (STAGES < n_it) load_slice(STAGES);
  cp_async_commit();
  fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < n_it; ++i) {
    // the slice's 4 eight-deep steps, small terms first, on the tensor cores
    {
      const uint32_t* a_big = split + (i & 1) * S::split_words + wg * 64 * BK;
      const uint32_t* a_small = a_big + S::a_words;
      const uint32_t* b_big = split + (i & 1) * S::split_words + 2 * S::a_words;
      const uint32_t* b_small = b_big + S::b_words;
      float (&d)[64] = kCarry ? part : acc;
      fence_operand(d);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int off = j * 64;  // two core matrices along K: 256 bytes
        wgmma_tf32(d, smem_desc(a_small + off, S::LBO, S::SBO),
                   smem_desc(b_big + off, S::LBO, S::SBO), kCarry ? j > 0 : 1);
        wgmma_tf32(d, smem_desc(a_big + off, S::LBO, S::SBO),
                   smem_desc(b_small + off, S::LBO, S::SBO), 1);
        wgmma_tf32(d, smem_desc(a_big + off, S::LBO, S::SBO),
                   smem_desc(b_big + off, S::LBO, S::SBO), 1);
      }
      wgmma_commit();
      fence_operand(d);
    }
    // meanwhile: split slice i + 1 (its buffer's last readers, slice i - 1's
    // wgmmas, are done) and start the loads of slice i + 1 + STAGES
    if (i + 1 < n_it) {
      cp_async_wait<STAGES - 1>();
      split_slice(i + 1);
      if (i + 1 + STAGES < n_it) load_slice(i + 1 + STAGES);
    }
    cp_async_commit();
    wgmma_wait_all();
    if (kCarry) {
      fence_operand(part);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
    }
    fence_proxy_async();
    __syncthreads();  // slice i + 1 is split; slice i's wgmmas are done
  }
  cp_async_wait<0>();

  // acc: warp ww of the warpgroup holds rows 16 ww + g (+ 8), columns
  // 8 j + 2 t4 (+ 1) in acc[4 j .. 4 j + 3]
  const int ww = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r = row0 + wg * 64 + ww * 16 + lane / 4;
  float* O = out + static_cast<long long>(b) * cap * d_out;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = col0 + 8 * j + 2 * (lane % 4);  // even: c < d_out => c + 1 < d_out
    if (c >= d_out) continue;
    if (r < cap)
      *reinterpret_cast<float2*>(O + static_cast<long long>(r) * d_out + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < cap)
      *reinterpret_cast<float2*>(O + static_cast<long long>(r + 8) * d_out + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16
// ---------------------------------------------------------------------------

// Warp layout of a BM x BN tile: WM x WN warps, each MT m16 by NT n8 tiles.
template <int BM>
struct Warps {
  static constexpr int WM = BM >= 64 ? 2 : 1;
  static constexpr int WN = 8 / WM;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
};

template <int BM>
struct Bf16Shape {
  static constexpr int BK = 32;            // k depth of one slice
  static constexpr int LDX = BK + 8;       // padded X row (bfloat16)
  static constexpr int LDW = BN + 8;       // padded W row (bfloat16)
  static constexpr int stage_elems = BM * LDX + BK * LDW;
  static constexpr int smem_bytes = STAGES * stage_elems * 2;
};

template <int BM>
__global__ void __launch_bounds__(kThreads)
moe_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const int* __restrict__ bundle_expert, int cap, int d_in,
                     int d_out, __nv_bfloat16* __restrict__ out) {
  using S = Bf16Shape<BM>;
  using L = Warps<BM>;
  constexpr int BK = S::BK, LDX = S::LDX, LDW = S::LDW;
  constexpr int MT = L::MT, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m_base = (warp / L::WN) * (BM / L::WM);
  const int n_base = (warp % L::WN) * (BN / L::WN);
  const __nv_bfloat16* X = x + static_cast<long long>(b) * cap * d_in;
  const __nv_bfloat16* W =
      w + static_cast<long long>(bundle_expert[b]) * d_in * d_out;
  const int n_it = (d_in + BK - 1) / BK;

  auto load_slice = [&](int i, int stage) {
    __nv_bfloat16* xs = smem + stage * S::stage_elems;
    __nv_bfloat16* ws = xs + BM * LDX;
    const int k0 = i * BK;
    for (int e = tid; e < BM * BK / 4; e += kThreads) {
      const int r = e / (BK / 4);
      const int kc = (e % (BK / 4)) * 4;
      const bool in = row0 + r < cap && k0 + kc < d_in;
      cp_async8(xs + r * LDX + kc,
                in ? X + static_cast<long long>(row0 + r) * d_in + k0 + kc : X,
                in);
    }
    for (int e = tid; e < BK * BN / 4; e += kThreads) {
      const int k = e / (BN / 4);
      const int n = (e % (BN / 4)) * 4;
      const bool in = k0 + k < d_in && col0 + n < d_out;
      cp_async8(ws + k * LDW + n,
                in ? W + static_cast<long long>(k0 + k) * d_out + col0 + n : W,
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
    const __nv_bfloat16* xs = smem + (i % STAGES) * S::stage_elems;
    const __nv_bfloat16* ws = xs + BM * LDX;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xs + (m_base + mt * 16 + g) * LDX + kk + 2 * t4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(xr);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * LDX);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * LDX + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned short* wc = reinterpret_cast<const unsigned short*>(
            ws + (kk + 2 * t4) * LDW + n_base + nt * 8 + g);
        const uint32_t bf[2] = {
            static_cast<uint32_t>(wc[0]) | (static_cast<uint32_t>(wc[LDW]) << 16),
            static_cast<uint32_t>(wc[8 * LDW]) |
                (static_cast<uint32_t>(wc[9 * LDW]) << 16)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], bf[0], bf[1]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* O = out + static_cast<long long>(b) * cap * d_out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + m_base + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + n_base + nt * 8 + 2 * t4;
      if (c >= d_out) continue;
      if (r < cap)
        *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long long>(r) * d_out + c) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < cap)
        *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long long>(r + 8) * d_out + c) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on TMA and wgmma (d_in and d_out multiples of 8)
// ---------------------------------------------------------------------------

// The schedule's walk (Walk, item_at), the mbarrier and TMA helpers,
// desc_sw128, wgmma at n = 256 and 128 and the tensor maps (bf16_map) are in
// moe_tma.cuh, which K5's backward shares.

// wgmma in bfloat16, fp32 accumulate, A MN-major (w's tile as A: 64 output
// columns), B K-major (x^T: 32 rows): d = a * b + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_bf16_n32_wt(float (&d)[16], uint64_t a_desc,
    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// -- the tile route: cap > 32, bound by operations ---------------------------

// BN output columns a block, two consumer warpgroups of 64 rows each (a
// unit: two 64-row tiles of one expert, from one bundle or two), one
// producer warp; 64-deep slices through a ring of STAGES.  288 threads a
// block and one block an SM leave 224 registers a thread: the consumers'
// 128 accumulators fit without moving registers between warpgroups.
#ifndef REPRO_K5_TMA_BN
#define REPRO_K5_TMA_BN 256
#endif
#ifndef REPRO_K5_TMA_STAGES
#define REPRO_K5_TMA_STAGES (REPRO_K5_TMA_BN == 256 ? 4 : 6)
#endif
#ifndef REPRO_K5_TMA_CARRY
#define REPRO_K5_TMA_CARRY 0  // 0: the tensor cores accumulate in place
#endif

template <int BN, int STAGES>
struct TileShape {
  static constexpr int a_bytes = 64 * 64 * 2;        // one 64 x 64 x tile: 8 KiB
  static constexpr int b_bytes = 64 * BN * 2;        // BN / 64 boxes of 64 x 64
  static constexpr int stage_bytes = 2 * a_bytes + b_bytes;
  static constexpr int bar_bytes = 2 * STAGES * 8;   // full and empty barriers
  static constexpr int smem_bytes = STAGES * stage_bytes + bar_bytes + 1024;
  static constexpr int threads = 288;                // 2 consumer warpgroups + 1 producer warp
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (BN == 256) wgmma_bf16_n256(d, a, b, scale_d);
  else wgmma_bf16_n128(d, a, b, scale_d);
}

template <int BN, int STAGES, int CARRY>
__global__ void __launch_bounds__(288, 1)
moe_gemm_tma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const int* __restrict__ sched, int nb, int n_groups,
                    int cap, int d_in, int d_out, long long n_items,
                    __nv_bfloat16* __restrict__ out) {
  using S = TileShape<BN, STAGES>;
  static_assert(CARRY == 0 || (BN <= 128 && CARRY % 64 == 0),
                "a carry needs a second accumulator: BN 128, whole slices");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = smem + STAGES * S::stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Walk walk{sched, sched + nb, sched + 2 * nb, n_groups, (cap + 63) / 64, 2,
            (d_out + BN - 1) / BN};
  const int n_k = (d_in + 63) / 64;

  if (tid >= 256) {
    // producer: one thread keeps the ring full
    if (tid == 256) {
      int stage = 0, phase = 0;
      for (long long t = blockIdx.x; t < n_items && walk.seek(t); t += gridDim.x) {
        const Item it = item_at(walk, t);
        for (int k = 0; k < n_k; ++k) {
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t st = smem + stage * S::stage_bytes;
          mbar_expect_tx(full(stage), it.n_slots * S::a_bytes + S::b_bytes);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < it.n_slots)
              tma_load_3d(st + i * S::a_bytes, &tx, 64 * k, 64 * it.tile[i],
                          it.bundle[i], full(stage));
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_3d(st + 2 * S::a_bytes + j * 8192, &tw, it.col * BN + 64 * j,
                        64 * k, it.expert, full(stage));
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg multiplies the unit's slot wg (rows 64 wg ..)
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    auto release = [&](int s) {  // this warp is done with stage s
      if (lane == 0) mbar_arrive(empty(s));
    };
    float acc[BN / 2];
    float part[BN / 2];  // CARRY > 0: the span's sum
    int stage = 0, phase = 0;
    for (long long t = blockIdx.x; t < n_items && walk.seek(t); t += gridDim.x) {
      const Item it = item_at(walk, t);
      const bool live = wg < it.n_slots;
      int prev = 0;
      for (int k = 0; k < n_k; ++k) {
        mbar_wait(full(stage), phase);
        if (live) {
          const uint32_t st = smem + stage * S::stage_bytes;
          const uint64_t da = desc_sw128(st + wg * S::a_bytes, 16, 1024);
          const uint64_t db = desc_sw128(st + 2 * S::a_bytes, 8192, 1024);
          if constexpr (CARRY == 0) {
            fence_operand(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 16 deep: A +32 bytes, B +2048
              wgmma_tile<BN>(acc, da + 2 * kk, db + 128 * kk, (k | kk) != 0);
            wgmma_commit();
            fence_operand(acc);
            wgmma_wait<1>();  // slice k - 1's products are done
          } else {
            // sum each CARRY-deep span from zero, then add it to acc in IEEE fp32
            constexpr int span = CARRY / 64;
            float (&d)[BN / 2] = part;
            fence_operand(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_tile<BN>(d, da + 2 * kk, db + 128 * kk, (k % span) | kk);
            wgmma_commit();
            fence_operand(d);
            if (k % span == span - 1 || k == n_k - 1) {
              wgmma_wait<0>();
              fence_operand(d);
#pragma unroll
              for (int e = 0; e < BN / 2; ++e) acc[e] = (k < span ? 0.0f : acc[e]) + d[e];
            } else {
              wgmma_wait<1>();
            }
          }
        }
        if (k > 0) release(prev);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();  // on every path: without rows nothing is outstanding
      fence_operand(acc);
      release(prev);
      if (!live) continue;

      // acc: warp `warp` holds rows 16 warp + lane / 4 (+ 8) of the slot,
      // columns 8 j + 2 (lane % 4) (+ 1) in acc[4 j .. 4 j + 3]
      const int r = 64 * it.tile[wg] + 16 * warp + lane / 4;
      __nv_bfloat16* O = out + static_cast<long long>(it.bundle[wg]) * cap * d_out;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = it.col * BN + 8 * j + 2 * (lane % 4);
        if (c >= d_out) continue;  // d_out % 8 == 0: c < d_out => c + 1 < d_out
        if (r < cap)
          *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r) * d_out + c) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < cap)
          *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r + 8) * d_out + c) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// -- the decode route: cap <= 32, bound by the bytes of the weights ---------

// A and B swapped: each of w's NW 64-column boxes is wgmma's A (M = 64
// output columns, MN-major), x^T its B (N = 32: the item's bundles' rows,
// each rounded up to rn = 8, 16, 24 or 32 rows, 32 / rn bundles of one
// expert side by side).  One consumer warpgroup, one producer warp; 64-deep
// slices of NW = 2 boxes (128 columns: 256 contiguous bytes a weight row)
// through a ring of 5 STAGES, two blocks an SM.
#ifndef REPRO_K5_DECODE_STAGES
#define REPRO_K5_DECODE_STAGES 5
#endif
#ifndef REPRO_K5_DECODE_BOXES
#define REPRO_K5_DECODE_BOXES 2
#endif

template <int STAGES, int NW>
struct DecodeShape {
  static constexpr int w_bytes = NW * 64 * 64 * 2;
  static constexpr int x_bytes = 32 * 128;
  static constexpr int stage_bytes = w_bytes + x_bytes;
  static constexpr int smem_bytes = STAGES * stage_bytes + 2 * STAGES * 8 + 1024;
  static constexpr int threads = 160;
};

template <int STAGES, int NW>
__global__ void __launch_bounds__(160, 2)
moe_gemm_decode_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw,
                       const int* __restrict__ sched, int nb, int n_groups,
                       int cap, int d_in, int d_out, long long n_items,
                       __nv_bfloat16* __restrict__ out) {
  using S = DecodeShape<STAGES, NW>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t smem = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = smem + STAGES * S::stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int rn = (cap + 7) / 8 * 8;
  Walk walk{sched, sched + nb, sched + 2 * nb, n_groups, 1, 32 / rn,
            (d_out + 64 * NW - 1) / (64 * NW)};
  const int n_k = (d_in + 63) / 64;

  if (tid >= 128) {
    if (tid != 128) return;
    int stage = 0, phase = 0;
    for (long long t = blockIdx.x; t < n_items && walk.seek(t); t += gridDim.x) {
      const Item it = item_at(walk, t);
      for (int k = 0; k < n_k; ++k) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t st = smem + stage * S::stage_bytes;
        mbar_expect_tx(full(stage), S::w_bytes + it.n_slots * rn * 128);
#pragma unroll
        for (int j = 0; j < NW; ++j)
          tma_load_3d(st + j * 8192, &tw, 64 * (NW * it.col + j), 64 * k,
                      it.expert, full(stage));
        for (int i = 0; i < it.n_slots; ++i)
          tma_load_3d(st + S::w_bytes + i * rn * 128, &tx, 64 * k, 0,
                      it.bundle[i], full(stage));
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[NW][16];
  int stage = 0, phase = 0;
  for (long long t = blockIdx.x; t < n_items && walk.seek(t); t += gridDim.x) {
    const Item it = item_at(walk, t);
    int prev = 0;
    for (int k = 0; k < n_k; ++k) {
      mbar_wait(full(stage), phase);
      const uint32_t st = smem + stage * S::stage_bytes;
      const uint64_t db = desc_sw128(st + S::w_bytes, 16, 1024);
#pragma unroll
      for (int j = 0; j < NW; ++j) fence_operand(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 deep: A +2048 bytes, B +32
#pragma unroll
        for (int j = 0; j < NW; ++j)
          wgmma_bf16_n32_wt(acc[j], desc_sw128(st + j * 8192, 8192, 1024) + 128 * kk,
                            db + 2 * kk, (k | kk) != 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NW; ++j) fence_operand(acc[j]);
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = stage;
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NW; ++j) fence_operand(acc[j]);
    if (lane == 0) mbar_arrive(empty(prev));

    // acc[b][4 j + e]: output column 64 (NW col + b) + 16 warp + lane / 4 (+ 8
    // for e >= 2), x^T column n = 8 j + 2 (lane % 4) + (e & 1): row n % rn of
    // slot n / rn
#pragma unroll
    for (int b = 0; b < NW; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 64 * (NW * it.col + b) + 16 * warp + lane / 4 + 8 * (e >> 1);
          const int n = 8 * j + 2 * (lane % 4) + (e & 1);
          const int slot = n / rn, row = n % rn;
          if (slot < it.n_slots && row < cap && c < d_out)
            out[(static_cast<long long>(it.bundle[slot]) * cap + row) * d_out + c] =
                __float2bfloat16_rn(acc[b][4 * j + e]);
        }
  }
}

#ifdef REPRO_K5_DECODE_ROWS
// The other decode candidate, built only for scripts/card_studies.py
// k5-bf16: moe_gemm_rows_kernel's streaming in bfloat16, 4 columns a
// thread (8-byte weight loads), x^T in float through shared memory.
constexpr int kRowsCols16 = 4 * kRowsThreads;

template <int RM>
__global__ void __launch_bounds__(kRowsThreads)
moe_gemm_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const int* __restrict__ bundle_expert, int cap,
                          int d_in, int d_out, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) float xs[KC][RM];
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kRowsCols16 + 4 * tid;  // d_out % 8 == 0
  const bool live = col < d_out;
  const __nv_bfloat16* X = x + static_cast<long long>(b) * cap * d_in;
  const __nv_bfloat16* W = w + static_cast<long long>(bundle_expert[b]) * d_in * d_out +
                           (live ? col : 0);
  auto wrow = [&](int k) {
    uint2 v = make_uint2(0u, 0u);
    if (live) v = *reinterpret_cast<const uint2*>(W + static_cast<long long>(k) * d_out);
    return v;
  };
  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < d_in; k0 += KC) {
    const int kn = min(KC, d_in - k0);
    __syncthreads();
    for (int e = tid; e < RM * KC / 8; e += kRowsThreads) {
      const int r = e % RM;
      const int kq = 8 * (e / RM);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < cap && kq < kn)
        v = *reinterpret_cast<const uint4*>(X + static_cast<long long>(r) * d_in + k0 + kq);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[kq + i][r] = __bfloat162float(h[i]);
    }
    __syncthreads();
    uint2 wn[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) wn[u] = u < kn ? wrow(k0 + u) : make_uint2(0u, 0u);
    for (int kk = 0; kk < kn; kk += kU) {
      uint2 wc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        wc[u] = wn[u];
        const int kf = kk + kU + u;
        wn[u] = kf < kn ? wrow(k0 + kf) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (kk + u >= kn) break;
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&wc[u]);
        float wf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) wf[c] = __bfloat162float(h[c]);
#pragma unroll
        for (int r4 = 0; r4 < RM; r4 += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[kk + u][r4]);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r4 + i][c] = fmaf(xr[i], wf[c], acc[r4 + i][c]);
        }
      }
    }
  }
  if (!live) return;
  __nv_bfloat16* O = out + static_cast<long long>(b) * cap * d_out + col;
#pragma unroll
  for (int r = 0; r < RM; ++r)
    if (r < cap)
      *reinterpret_cast<uint2*>(O + static_cast<long long>(r) * d_out) =
          make_uint2(pack_bf16(acc[r][0], acc[r][1]), pack_bf16(acc[r][2], acc[r][3]));
}
#endif  // REPRO_K5_DECODE_ROWS

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int RM>
int launch_rows(const float* x, const float* w, const int* bundle_expert,
                int nb, int cap, int d_in, int d_out, float* out,
                cudaStream_t stream) {
  const dim3 grid(1, (d_out + kRowsCols - 1) / kRowsCols, nb);
  moe_gemm_rows_kernel<RM><<<grid, kRowsThreads, 0, stream>>>(
      x, w, bundle_expert, cap, d_in, d_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int WGS>
int launch_wgmma(const float* x, const float* w, const int* bundle_expert,
                 int nb, int cap, int d_in, int d_out, float* out,
                 cudaStream_t stream, int device) {
  using S = WgShape<WGS>;
  static_assert(S::smem_bytes <= 232448, "above the 227 KiB a block may use");
  auto* kernel = moe_gemm_wgmma_kernel<WGS>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, S::smem_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cap + S::BM - 1) / S::BM, (d_out + BN - 1) / BN, nb);
  kernel<<<grid, S::threads, S::smem_bytes, stream>>>(x, w, bundle_expert, cap,
                                                      d_in, d_out, out);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const int* bundle_expert, int nb, int cap, int d_in, int d_out,
                __nv_bfloat16* out, cudaStream_t stream, int device) {
  constexpr int bytes = Bf16Shape<BM>::smem_bytes;
  auto* kernel = moe_gemm_bf16_kernel<BM>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cap + BM - 1) / BM, (d_out + BN - 1) / BN, nb);
  kernel<<<grid, kThreads, bytes, stream>>>(x, w, bundle_expert, cap, d_in,
                                            d_out, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_bm(int bm, const float* x, const float* w,
                  const int* bundle_expert, int nb, int cap, int d_in,
                  int d_out, float* out, cudaStream_t s, int device) {
  if (bm <= 32) {  // cap <= 32: rows rounded up to 8
    switch ((cap + 7) / 8) {
      case 1: return launch_rows<8>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s);
      case 2: return launch_rows<16>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s);
      case 3: return launch_rows<24>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s);
      case 4: return launch_rows<32>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (bm) {
    case 64: return launch_wgmma<1>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s, device);
    case 128: return launch_wgmma<2>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_bf16_bm(int bm, const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const int* bundle_expert, int nb, int cap, int d_in,
                   int d_out, __nv_bfloat16* out, cudaStream_t s, int device) {
  switch (bm) {
    case 16: return launch_bf16<16>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s, device);
    case 32: return launch_bf16<32>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s, device);
    case 64: return launch_bf16<64>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s, device);
    case 128: return launch_bf16<128>(x, w, bundle_expert, nb, cap, d_in, d_out, out, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// -- the TMA routes ----------------------------------------------------------

// x: (nb, cap, d_in), w: (n_experts, d_in, d_out); n_units: the schedule's
// units (Walk), so n_units * column tiles work items.
template <int BN, int STAGES, int CARRY>
int launch_tma_tiles(const void* x, const void* w, const int* sched, int nb,
                     int n_groups, int cap, int d_in, int d_out, int n_experts,
                     long long n_units, void* out, cudaStream_t stream,
                     int device) {
  using S = TileShape<BN, STAGES>;
  static_assert(S::smem_bytes <= 232448, "above the 227 KiB a block may use");
  CUtensorMap tx, tw;
  int err = bf16_map(&tx, x, d_in, cap, nb, 64, 64);
  if (!err) err = bf16_map(&tw, w, d_out, d_in, n_experts, 64, 64);
  int sms = 0;
  if (!err) err = sm_count(device, &sms);
  if (err) return err;
  auto* kernel = moe_gemm_tma_kernel<BN, STAGES, CARRY>;
  static std::atomic<int> smem_set[64];
  cudaError_t e = allow_smem(smem_set, kernel, S::smem_bytes, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_items = n_units * ((d_out + BN - 1) / BN);
  const int grid = static_cast<int>(std::min<long long>(n_items, sms));
  kernel<<<grid, S::threads, S::smem_bytes, stream>>>(
      tx, tw, sched, nb, n_groups, cap, d_in, d_out, n_items,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int STAGES, int NW>
int launch_tma_decode(const void* x, const void* w, const int* sched, int nb,
                      int n_groups, int cap, int d_in, int d_out,
                      int n_experts, long long n_units, void* out,
                      cudaStream_t stream, int device) {
  using S = DecodeShape<STAGES, NW>;
  CUtensorMap tx, tw;
  int err = bf16_map(&tx, x, d_in, cap, nb, 64, (cap + 7) / 8 * 8);
  if (!err) err = bf16_map(&tw, w, d_out, d_in, n_experts, 64, 64);
  int sms = 0;
  if (!err) err = sm_count(device, &sms);
  if (err) return err;
  auto* kernel = moe_gemm_decode_kernel<STAGES, NW>;
  static std::atomic<int> smem_set[64];
  cudaError_t e = allow_smem(smem_set, kernel, S::smem_bytes, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::threads,
                                                    S::smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_items = n_units * ((d_out + 64 * NW - 1) / (64 * NW));
  const int grid = static_cast<int>(std::min<long long>(n_items, per_sm * sms));
  kernel<<<grid, S::threads, S::smem_bytes, stream>>>(
      tx, tw, sched, nb, n_groups, cap, d_in, d_out, n_items,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K5 on `stream`: nb bundles of cap rows, d_in -> d_out, row tile bm
// in {16, 32, 64, 128}; dtype 0 = float32, 1 = bfloat16 (x, w and out alike).
// The
// caller has checked dtypes, shapes (nb, cap, d_in, d_out >= 1; d_in and d_out
// multiples of 4; nb <= 65535), 16-byte alignment, contiguity and that every
// bundle_expert entry is a valid expert.  Returns the first CUDA error of the
// attribute call or the launch.
int moe_gemm(const void* x, const void* w, const int* bundle_expert, int nb,
             int cap, int d_in, int d_out, int bm, int dtype,
             void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    return launch_f32_bm(bm, xf, wf, bundle_expert, nb, cap, d_in, d_out, of, s, device);
  }
  if (dtype == 1)
    return launch_bf16_bm(bm, static_cast<const __nv_bfloat16*>(x),
                          static_cast<const __nv_bfloat16*>(w), bundle_expert,
                          nb, cap, d_in, d_out,
                          static_cast<__nv_bfloat16*>(out), s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches K5's bfloat16 TMA routes on `stream`: route 1 the tiles (cap >
// 32), route 2 decode (cap <= 32).  `sched` is the schedule buffer (the
// layout above Walk) with n_groups groups and n_units units; d_in and d_out
// are multiples of 8 and x, w and out 16-byte aligned (the caller has
// checked).  Returns the first error of the tensor-map encodes (kEncodeFailed
// + its CUresult), the attribute calls or the launch.
int moe_gemm_bf16_tma(const void* x, const void* w, const int* sched, int nb,
                      int n_groups, int cap, int d_in, int d_out, int n_experts,
                      long long n_units, int route, void* out, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return launch_tma_tiles<REPRO_K5_TMA_BN, REPRO_K5_TMA_STAGES, REPRO_K5_TMA_CARRY>(
        x, w, sched, nb, n_groups, cap, d_in, d_out, n_experts, n_units, out, s,
        device);
#ifdef REPRO_K5_DECODE_ROWS
  if (route == 2) {
    const dim3 grid(1, (d_out + kRowsCols16 - 1) / kRowsCols16, nb);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    switch ((cap + 7) / 8) {
      case 1: moe_gemm_rows_bf16_kernel<8><<<grid, kRowsThreads, 0, s>>>(xb, wb, sched, cap, d_in, d_out, ob); break;
      case 2: moe_gemm_rows_bf16_kernel<16><<<grid, kRowsThreads, 0, s>>>(xb, wb, sched, cap, d_in, d_out, ob); break;
      case 3: moe_gemm_rows_bf16_kernel<24><<<grid, kRowsThreads, 0, s>>>(xb, wb, sched, cap, d_in, d_out, ob); break;
      default: moe_gemm_rows_bf16_kernel<32><<<grid, kRowsThreads, 0, s>>>(xb, wb, sched, cap, d_in, d_out, ob); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
#endif
  if (route == 2)
    return launch_tma_decode<REPRO_K5_DECODE_STAGES, REPRO_K5_DECODE_BOXES>(
        x, w, sched, nb, n_groups, cap, d_in, d_out, n_experts, n_units, out, s,
        device);
  return static_cast<int>(cudaErrorInvalidValue);
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
