// Block-sparse weight x dense activation matmul (kernel K2) for Hopper, sm_90a.
//
//   Y[:, j*BS:(j+1)*BS] = sum over jobs p of group j:  X[:, k_blk[p]*BS : +BS] @ W[w_id[p]]
//
// Replaces the Pallas TPU kernel repro.kernels.bsr_spmm.bsr_spmm
// (src/repro/kernels/bsr_spmm.py:119).  The TPU version walks one grid step per
// job and keeps the output tile in VMEM across its group; here one thread block
// owns one (token tile, output group) pair: it loops over the group's jobs,
// keeps the fp32 accumulator on chip, and writes the tile once with no atomics.
// The schedule holds one group per output block-column (coverage jobs multiply
// an appended zero tile), so every output element is written exactly once.
//
// Two variants, picked from the token count t of the call:
//  * tile (t > 8): a BT x BS output tile per thread block (BT = 128 with 8
//    warps, or 32 with 4 warps when t < 64) on the tensor cores in 3xTF32,
//    CUTLASS's OpMultiplyAddFastF32 idea: each fp32 operand is split into
//    big = tf32(x) and small = tf32(x - big) (both rounded to nearest), and
//    mma.sync m16n8k8 sums small*big + big*small + big*big, which keeps
//    fp32 accuracy (the reference holds K2 to 1e-4, which plain TF32 misses)
//    at three tensor-core products per product, the small terms first.  The
//    tensor cores sum the products of each 16-deep step from zero, and IEEE
//    adds carry those sums into the output's accumulator: the tensor cores'
//    own accumulation truncates.  Two blocks share an SM (128 registers a
//    thread).  The group's jobs are walked as one sequence of KC-deep
//    slices (KC = 32, or BS when BS < 32): the X panel (BT x KC, rows
//    padded by 4 floats) and the W slice (KC x BS, rows padded by 8 floats;
//    W's [k][n] tiles need no transpose for mma.sync's B fragments) go through
//    a 3-stage cp.async ring, so the loads of slices i + 1 and i + 2 are in
//    flight while slice i is multiplied.  The paddings put the 32 lanes of
//    every fragment load in distinct banks.  Rows past t load as zeros and
//    are not stored.  Bound at filter3D T = 256: 3 x 20.8 GFLOP of TF32
//    products over 495 TFLOP/s, 0.126 ms (the fp32 FMA bound is 0.311 ms).
//  * gemv (t <= 8, the solver's matvec has t = 1): one thread block per
//    (output group, token row).  Each W tile is streamed once, each of the 256
//    threads reading column c = tid % BS of a k-slice (coalesced rows of W),
//    the x slab broadcast from shared memory; the k-slices are summed in
//    shared memory at the end.  IEEE fp32 FMAs.  Bound by the bytes of W.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error of
// the attribute call or the launch (0 on success).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int BS, int BT>
struct TileShape {
  static constexpr int WM = BT == 128 ? 4 : 2;  // warps along the rows
  static constexpr int WN = 2;                  // warps along the columns
  static constexpr int threads = WM * WN * 32;
  static constexpr int MT = BT / WM / 16;       // m16 tiles per warp
  static constexpr int NT = BS / WN / 8;        // n8 tiles per warp
  static constexpr int KC = BS < 32 ? BS : 32;  // k depth of one slice
  static_assert(KC % 16 == 0, "a slice is walked 16 deep");
  static constexpr int LDX = KC + 4;            // padded X panel row (floats)
  static constexpr int LDW = BS + 8;            // padded W slice row (floats)
  static constexpr int STAGES = 3;
  static constexpr int stage_floats = BT * LDX + KC * LDW;
  static constexpr int smem_bytes =
      STAGES * stage_floats * static_cast<int>(sizeof(float));
};

template <int BS, int BT>
__global__ void __launch_bounds__(TileShape<BS, BT>::threads, 2)
spmm_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const int* __restrict__ w_id, const int* __restrict__ k_blk,
                 const int* __restrict__ j_blk,
                 const int* __restrict__ group_start, int t, int ldx, int ldy,
                 float* __restrict__ y) {
  using S = TileShape<BS, BT>;
  constexpr int KC = S::KC, LDX = S::LDX, LDW = S::LDW;
  constexpr int MT = S::MT, NT = S::NT, STAGES = S::STAGES;
  constexpr int NKC = BS / KC;  // slices per job
  extern __shared__ __align__(16) float smem[];

  // the token tiles of one group are neighbours in the grid, so the second
  // reads the group's W tiles from L2
  const int n_tt = (t + BT - 1) / BT;
  const int g0 = blockIdx.x / n_tt;
  const int row0 = (blockIdx.x % n_tt) * BT;
  const int p0 = group_start[g0];
  const int n_it = (group_start[g0 + 1] - p0) * NKC;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m_base = (warp / S::WN) * (BT / S::WM);
  const int n_base = (warp % S::WN) * (BS / S::WN);

  // slice i of the group: job p0 + i / NKC, k columns (i % NKC) * KC + [0, KC)
  auto load_slice = [&](int i, int stage) {
    const int p = p0 + i / NKC;
    const int kc = (i % NKC) * KC;
    const float* X = x + static_cast<long long>(k_blk[p]) * BS + kc;
    const float* W = w + static_cast<long long>(w_id[p]) * BS * BS +
                     static_cast<long long>(kc) * BS;
    float* xs = smem + stage * S::stage_floats;
    float* ws = xs + BT * LDX;
    for (int e = tid; e < BT * KC / 4; e += S::threads) {
      const int r = e / (KC / 4);
      const int c = (e % (KC / 4)) * 4;
      const bool in = row0 + r < t;
      cp_async16(xs + r * LDX + c,
                 X + static_cast<long long>(in ? row0 + r : 0) * ldx + c, in);
    }
    for (int e = tid; e < KC * BS / 4; e += S::threads) {
      const int r = e / (BS / 4);
      const int c = (e % (BS / 4)) * 4;
      cp_async16(ws + r * LDW + c, W + r * BS + c, true);
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
    const float* xs = smem + (i % STAGES) * S::stage_floats;
    const float* ws = xs + BT * LDX;
    // two 8-deep steps at a time: their six products per output, the small
    // terms first, are summed from zero and then added to the accumulator
    // with IEEE adds.  The tensor cores' accumulation truncates; into a
    // running sum that has grown large, step after step, that cost about
    // 1e-4 where outputs nearly cancel (against 3e-5 for plain fp32).
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a_big[2][MT][4], a_small[2][MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xr =
              xs + (m_base + mt * 16 + g) * LDX + kk + 8 * h + t4;
          split_tf32(xr[0], a_big[h][mt][0], a_small[h][mt][0]);
          split_tf32(xr[8 * LDX], a_big[h][mt][1], a_small[h][mt][1]);
          split_tf32(xr[4], a_big[h][mt][2], a_small[h][mt][2]);
          split_tf32(xr[8 * LDX + 4], a_big[h][mt][3], a_small[h][mt][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float c[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[mt][e] = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* wc = ws + (kk + 8 * h + t4) * LDW + n_base + nt * 8 + g;
          uint32_t b_big[2], b_small[2];
          split_tf32(wc[0], b_big[0], b_small[0]);
          split_tf32(wc[4 * LDW], b_big[1], b_small[1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], a_small[h][mt], b_big);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], a_big[h][mt], b_small);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], a_big[h][mt], b_big);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += c[mt][e];
      }
    }
  }
  cp_async_wait<0>();

  float* Y = y + static_cast<long long>(row0) * ldy +
             static_cast<long long>(j_blk[p0]) * BS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = m_base + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = n_base + nt * 8 + 2 * t4;
      if (row0 + r < t)
        *reinterpret_cast<float2*>(Y + static_cast<long long>(r) * ldy + c) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (row0 + r + 8 < t)
        *reinterpret_cast<float2*>(Y + static_cast<long long>(r + 8) * ldy + c) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int BS>
__global__ void __launch_bounds__(kThreads)
spmm_gemv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const int* __restrict__ w_id, const int* __restrict__ k_blk,
                 const int* __restrict__ j_blk,
                 const int* __restrict__ group_start, int ldx, int ldy,
                 float* __restrict__ y) {
  constexpr int KS = kThreads / BS;  // k-slices
  constexpr int KL = BS / KS;        // k per slice
  __shared__ float xs[BS];
  __shared__ float part[KS][BS];

  const int g = blockIdx.x;
  const int row = blockIdx.y;
  const int p0 = group_start[g];
  const int p1 = group_start[g + 1];
  const int tid = threadIdx.x;
  const int c = tid % BS;
  const int k_lo = (tid / BS) * KL;

  float acc = 0.0f;
  for (int p = p0; p < p1; ++p) {
    const float* X = x + static_cast<long long>(row) * ldx +
                     static_cast<long long>(k_blk[p]) * BS;
    const float* W = w + static_cast<long long>(w_id[p]) * BS * BS;
    __syncthreads();  // the previous job's reads of xs are done
    if (tid < BS) xs[tid] = X[tid];
    __syncthreads();
#pragma unroll 8
    for (int k = k_lo; k < k_lo + KL; ++k) acc = fmaf(xs[k], W[k * BS + c], acc);
  }
  part[tid / BS][c] = acc;
  __syncthreads();
  if (tid < BS) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < KS; ++q) s += part[q][tid];
    y[static_cast<long long>(row) * ldy +
      static_cast<long long>(j_blk[p0]) * BS + tid] = s;
  }
}

template <int BS, int BT>
int launch_tile(const float* x, const float* w, const int* w_id,
                const int* k_blk, const int* j_blk, const int* group_start,
                int n_groups, int t, int ldx, int ldy, float* y,
                cudaStream_t stream, int device) {
  using S = TileShape<BS, BT>;
  auto* kernel = spmm_tile_kernel<BS, BT>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, S::smem_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_groups * ((t + BT - 1) / BT), S::threads, S::smem_bytes,
           stream>>>(x, w, w_id, k_blk, j_blk, group_start, t, ldx, ldy, y);
  return static_cast<int>(cudaGetLastError());
}

template <int BS>
int launch(const float* x, const float* w, const int* w_id, const int* k_blk,
           const int* j_blk, const int* group_start, int n_groups, int t,
           int ldx, int ldy, float* y, cudaStream_t stream, int device) {
  if (t <= 8) {
    spmm_gemv_kernel<BS><<<dim3(n_groups, t), kThreads, 0, stream>>>(
        x, w, w_id, k_blk, j_blk, group_start, ldx, ldy, y);
    return static_cast<int>(cudaGetLastError());
  }
  if (t < 64)
    return launch_tile<BS, 32>(x, w, w_id, k_blk, j_blk, group_start,
                               n_groups, t, ldx, ldy, y, stream, device);
  return launch_tile<BS, 128>(x, w, w_id, k_blk, j_blk, group_start, n_groups,
                              t, ldx, ldy, y, stream, device);
}

}  // namespace

extern "C" {

// Launches K2 on `stream` over n_groups output block-columns and t token rows
// of x (row stride ldx floats) into y (row stride ldy floats).  The caller has
// checked dtypes, shapes, 16-byte alignment, index ranges and that group g
// writes block-column g, and passes n_groups >= 1 and t >= 1.  Returns
// the first CUDA error of the attribute call or the launch (0 on success).
int bsr_spmm_f32(const float* x, const float* w, const int* w_id,
                 const int* k_blk, const int* j_blk, const int* group_start,
                 int n_groups, int t, int ldx, int ldy, int bs, float* y,
                 void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: return launch<16>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s, device);
    case 32: return launch<32>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s, device);
    case 64: return launch<64>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s, device);
    case 128: return launch<128>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
