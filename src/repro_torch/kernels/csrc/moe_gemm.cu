// Capacity-bundled expert GEMM (kernel K5) for Hopper, sm_90a.
//
//   out[b] = x[b] @ w[bundle_expert[b]]     x: (nb, cap, d_in)  w: (E, d_in, d_out)
//
// Replaces the Pallas TPU kernel repro.kernels.moe_gemm.moe_gemm
// (src/repro/kernels/moe_gemm.py:43).  The TPU version prefetches the
// bundle->expert map as a scalar operand and walks d_in as its innermost,
// sequential grid axis with the output tile resident in VMEM.  Here one thread
// block owns one (bundle, cap tile, d_out tile): it reads bundle_expert[b]
// itself, loops over d_in in BK-deep slices staged through shared memory, keeps
// the fp32 accumulators in registers and stores the tile once in x's dtype.
//
// Tile: BM x 128 outputs per thread block, 256 threads as a 16 x 16 grid,
// thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j.  BM is picked from
// cap by the caller (16, 32, 64 or 128), so a decode bundle of 24 rows runs in
// a 32-row tile instead of wasting 5/6 of a 128-row one, and each thread block
// streams its 128-column slice of the expert's weights exactly once.  The x
// slice is stored transposed (padded by one word); rows past cap, columns past
// d_out and k past d_in load zeros and are not stored.  Loads are 4 elements
// wide (float4, or 8 bytes of bfloat16), so d_in and d_out must be multiples of
// 4 and the operands 16-byte aligned (the wrapper checks).
//
// Products are IEEE fp32 FMAs (no TF32); bfloat16 is widened on load and the
// output rounded once on store.
//
// C entry point: plain C interface for ctypes; returns cudaGetLastError()
// after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BN = 128;
constexpr int BK = 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ bundle_expert, int cap, int d_in,
                int d_out, T* __restrict__ out) {
  constexpr int TR = BM / 16;
  constexpr int TC = BN / 16;
  __shared__ __align__(16) float Xs[BK][BM + 1];
  __shared__ __align__(16) float Ws[BK][BN];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* X = x + static_cast<long long>(b) * cap * d_in;
  const T* W = w + static_cast<long long>(bundle_expert[b]) * d_in * d_out;

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d_in; k0 += BK) {
    // x slice: BM rows x BK columns, 4 wide along k, stored transposed.
    for (int v = tid; v < BM * BK / 4; v += kThreads) {
      const int m = v / (BK / 4);
      const int k = (v % (BK / 4)) * 4;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row0 + m < cap && k0 + k < d_in)
        val = load4(X + static_cast<long long>(row0 + m) * d_in + k0 + k);
      Xs[k + 0][m] = val.x;
      Xs[k + 1][m] = val.y;
      Xs[k + 2][m] = val.z;
      Xs[k + 3][m] = val.w;
    }
    // w slice: BK rows x BN columns, 4 wide along d_out.
    for (int v = tid; v < BK * BN / 4; v += kThreads) {
      const int k = v / (BN / 4);
      const int n = (v % (BN / 4)) * 4;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + k < d_in && col0 + n < d_out)
        val = load4(W + static_cast<long long>(k0 + k) * d_out + col0 + n);
      *reinterpret_cast<float4*>(&Ws[k][n]) = val;
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

  T* O = out + static_cast<long long>(b) * cap * d_out;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r < cap) {
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = col0 + tx + 16 * j;
        if (c < d_out) store1(O + static_cast<long long>(r) * d_out + c, acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const T* x, const T* w, const int* bundle_expert, int nb, int cap,
           int d_in, int d_out, int bm, T* out, cudaStream_t stream) {
  const dim3 grid((d_out + BN - 1) / BN, (cap + bm - 1) / bm, nb);
  switch (bm) {
    case 16: moe_gemm_kernel<T, 16><<<grid, kThreads, 0, stream>>>(x, w, bundle_expert, cap, d_in, d_out, out); break;
    case 32: moe_gemm_kernel<T, 32><<<grid, kThreads, 0, stream>>>(x, w, bundle_expert, cap, d_in, d_out, out); break;
    case 64: moe_gemm_kernel<T, 64><<<grid, kThreads, 0, stream>>>(x, w, bundle_expert, cap, d_in, d_out, out); break;
    case 128: moe_gemm_kernel<T, 128><<<grid, kThreads, 0, stream>>>(x, w, bundle_expert, cap, d_in, d_out, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches K5 on `stream`: nb bundles of cap rows, d_in -> d_out, row tile bm
// in {16, 32, 64, 128}; dtype 0 = float32, 1 = bfloat16 (x, w and out alike).
// The caller has checked dtypes, shapes (nb, cap, d_in, d_out >= 1; d_in and
// d_out multiples of 4; nb <= 65535), 16-byte alignment, contiguity and that
// every bundle_expert entry is a valid expert.  Returns cudaGetLastError()
// after the launch.
int moe_gemm(const void* x, const void* w, const int* bundle_expert, int nb,
             int cap, int d_in, int d_out, int bm, int dtype, void* out,
             void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                  bundle_expert, nb, cap, d_in, d_out, bm,
                  static_cast<float*>(out), s);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<const __nv_bfloat16*>(w), bundle_expert, nb, cap,
                  d_in, d_out, bm, static_cast<__nv_bfloat16*>(out), s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
