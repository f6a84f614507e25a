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
//  * tile (t > 8): BT x BS output tile per thread block (BT = 128, or 16 when
//    t < 64), 256 threads as a 16 x 16 grid, thread (ty, tx) owns rows
//    ty + 16*i and columns tx + 16*j.  X[:, k-panel] is stored transposed in
//    Xs (padded by one word) and W[k-panel, :] in Ws, 32 deep (BS when
//    BS < 32), both loaded as float4; rows past t load zeros and are not
//    stored.  At BS = 128, BT = 128 this is K1's inner loop: bound by fp32
//    operations.
//  * gemv (t <= 8, the solver's matvec has t = 1): one thread block per
//    (output group, token row).  Each W tile is streamed once, each of the 256
//    threads reading column c = tid % BS of a k-slice (coalesced rows of W),
//    the x slab broadcast from shared memory; the k-slices are summed in
//    shared memory at the end.  Bound by the bytes of W.
// Products are IEEE fp32 FMAs (no TF32): the reference holds K2 to 1e-4.
//
// C entry point: plain C interface for ctypes; returns cudaGetLastError()
// after the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BS, int BT>
__global__ void __launch_bounds__(kThreads)
spmm_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const int* __restrict__ w_id, const int* __restrict__ k_blk,
                 const int* __restrict__ j_blk,
                 const int* __restrict__ group_start, int t, int ldx, int ldy,
                 float* __restrict__ y) {
  constexpr int TR = BT / 16;
  constexpr int TC = BS / 16;
  constexpr int BK = BS < 32 ? BS : 32;
  __shared__ __align__(16) float Xs[BK][BT + 1];
  __shared__ __align__(16) float Ws[BK][BS];

  const int g = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int p0 = group_start[g];
  const int p1 = group_start[g + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  for (int p = p0; p < p1; ++p) {
    const float* X = x + static_cast<long long>(row0) * ldx +
                     static_cast<long long>(k_blk[p]) * BS;
    const float* W = w + static_cast<long long>(w_id[p]) * BS * BS;
    for (int k0 = 0; k0 < BS; k0 += BK) {
      // X panel: BT rows x BK columns, float4 along k, stored transposed.
      for (int v = tid; v < BT * BK / 4; v += kThreads) {
        const int m = v / (BK / 4);
        const int k = (v % (BK / 4)) * 4;
        float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (row0 + m < t)
          val = *reinterpret_cast<const float4*>(
              X + static_cast<long long>(m) * ldx + k0 + k);
        Xs[k + 0][m] = val.x;
        Xs[k + 1][m] = val.y;
        Xs[k + 2][m] = val.z;
        Xs[k + 3][m] = val.w;
      }
      // W panel: BK rows x BS columns, float4 along n.
      for (int v = tid; v < BK * BS / 4; v += kThreads) {
        const int k = v / (BS / 4);
        const int n = (v % (BS / 4)) * 4;
        *reinterpret_cast<float4*>(&Ws[k][n]) =
            *reinterpret_cast<const float4*>(W + (k0 + k) * BS + n);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float ar[TR], br[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) ar[i] = Xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TC; ++j) br[j] = Ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* Y = y + static_cast<long long>(row0) * ldy +
             static_cast<long long>(j_blk[p0]) * BS;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r < t) {
#pragma unroll
      for (int j = 0; j < TC; ++j)
        Y[static_cast<long long>(r) * ldy + tx + 16 * j] = acc[i][j];
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

template <int BS>
void launch(const float* x, const float* w, const int* w_id, const int* k_blk,
            const int* j_blk, const int* group_start, int n_groups, int t,
            int ldx, int ldy, float* y, cudaStream_t stream) {
  if (t <= 8) {
    spmm_gemv_kernel<BS><<<dim3(n_groups, t), kThreads, 0, stream>>>(
        x, w, w_id, k_blk, j_blk, group_start, ldx, ldy, y);
  } else if (t < 64) {
    spmm_tile_kernel<BS, 16><<<dim3(n_groups, (t + 15) / 16), kThreads, 0,
                               stream>>>(x, w, w_id, k_blk, j_blk, group_start,
                                         t, ldx, ldy, y);
  } else {
    spmm_tile_kernel<BS, 128><<<dim3(n_groups, (t + 127) / 128), kThreads, 0,
                                stream>>>(x, w, w_id, k_blk, j_blk,
                                          group_start, t, ldx, ldy, y);
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream` over n_groups output block-columns and t token rows
// of x (row stride ldx floats) into y (row stride ldy floats).  The caller has
// checked dtypes, shapes, 16-byte alignment, index ranges and that group g
// writes block-column g, and passes n_groups >= 1 and t >= 1.  Returns
// cudaGetLastError() after the launch.
int bsr_spmm_f32(const float* x, const float* w, const int* w_id,
                 const int* k_blk, const int* j_blk, const int* group_start,
                 int n_groups, int t, int ldx, int ldy, int bs, float* y,
                 void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: launch<16>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s); break;
    case 32: launch<32>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s); break;
    case 64: launch<64>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s); break;
    case 128: launch<128>(x, w, w_id, k_blk, j_blk, group_start, n_groups, t, ldx, ldy, y, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
