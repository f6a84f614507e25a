// Block SpGEMM (kernel K1) for Hopper, sm_90a.
//
//   C[out_id[t]] += A[a_id[t]] @ B[b_id[t]]   over a schedule sorted by out_id
//
// Replaces the Pallas TPU kernel repro.kernels.bsr_spgemm.bsr_spgemm
// (src/repro/kernels/bsr_spgemm.py:41).  The TPU version walks one grid step
// per block pair and keeps the output tile in VMEM across its group; here one
// thread block owns one output group (a run of equal out_id, given by
// group_start), keeps the BS x BS fp32 accumulator in registers, and writes the
// tile once with no atomics.  Groups are independent, so the 132 SMs take them
// in any order.
//
// Bound: 2*BS^3 fp32 FLOP per pair on 2*BS^2*4 bytes of operands, so at
// BS = 128 it is bound by fp32 operations (67 TFLOP/s), not bytes.  Products
// are IEEE fp32 FMAs (no TF32: the reference holds K1 to 1e-5).
//
// Layout: 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16*i
// and columns tx + 16*j (i, j < TM = BS/16), so a warp's shared-memory reads of
// B are 16 consecutive words and of A a broadcast.  Each pair is consumed in
// K panels of BK = min(32, BS): A[:, k0:k0+BK] stored transposed in As (padded
// by one word so the transposing stores hit distinct banks) and
// B[k0:k0+BK, :] in Bs, both loaded as float4.
//
// C entry point: plain C interface for ctypes; returns cudaGetLastError()
// after the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const int* __restrict__ a_id, const int* __restrict__ b_id,
                  const int* __restrict__ out_id,
                  const int* __restrict__ group_start,
                  float* __restrict__ c) {
  constexpr int TM = BS / 16;
  constexpr int BK = BS < 32 ? BS : 32;
  constexpr int TILE = BS * BS;
  __shared__ __align__(16) float As[BK][BS + 1];
  __shared__ __align__(16) float Bs[BK][BS];

  const int g = blockIdx.x;
  const int p0 = group_start[g];
  const int p1 = group_start[g + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

  for (int p = p0; p < p1; ++p) {
    const float* A = a + static_cast<long long>(a_id[p]) * TILE;
    const float* B = b + static_cast<long long>(b_id[p]) * TILE;
    for (int k0 = 0; k0 < BS; k0 += BK) {
      // A panel: BS rows x BK columns, float4 along k, stored transposed.
      for (int v = tid; v < BS * BK / 4; v += kThreads) {
        const int m = v / (BK / 4);
        const int k = (v % (BK / 4)) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(A + m * BS + k0 + k);
        As[k + 0][m] = x.x;
        As[k + 1][m] = x.y;
        As[k + 2][m] = x.z;
        As[k + 3][m] = x.w;
      }
      // B panel: BK rows x BS columns, float4 along n.
      for (int v = tid; v < BK * BS / 4; v += kThreads) {
        const int k = v / (BS / 4);
        const int n = (v % (BS / 4)) * 4;
        *reinterpret_cast<float4*>(&Bs[k][n]) =
            *reinterpret_cast<const float4*>(B + (k0 + k) * BS + n);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float ar[TM], br[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ar[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TM; ++j) br[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* C = c + static_cast<long long>(out_id[p0]) * TILE;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) C[(ty + 16 * i) * BS + tx + 16 * j] = acc[i][j];
}

template <int BS>
void launch(const float* a, const float* b, const int* a_id, const int* b_id,
            const int* out_id, const int* group_start, int n_groups, float* c,
            cudaStream_t stream) {
  bsr_spgemm_kernel<BS><<<n_groups, kThreads, 0, stream>>>(
      a, b, a_id, b_id, out_id, group_start, c);
}

}  // namespace

extern "C" {

// Launches one thread block per output group on `stream`.  The caller has
// checked dtypes, shapes, 16-byte alignment and index ranges, zeroed `c`, and
// passes n_groups >= 1.  Returns cudaGetLastError() after the launch.
int bsr_spgemm_f32(const float* a, const float* b, const int* a_id,
                   const int* b_id, const int* out_id, const int* group_start,
                   int n_groups, int bs, float* c, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: launch<16>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s); break;
    case 32: launch<32>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s); break;
    case 64: launch<64>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s); break;
    case 128: launch<128>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
