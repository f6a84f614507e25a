// Block-sparse (gathered) flash attention (kernel K3) for Hopper, sm_90a.
//
//   out[b, h, q block qi] = softmax over the kv blocks kv_ids[qi, :n_kv[qi]]
//                           of (q k^T * scale, softcapped, positions >= seq
//                           masked) @ v,   kv head = h / (H / Hkv)
//
// Replaces the Pallas TPU kernel
// repro.kernels.flash_attention.block_sparse_attention
// (src/repro/kernels/flash_attention.py:274).  The TPU version walks the kv
// slots as a sequential grid axis with the running max, sum and accumulator in
// VMEM scratch; here one thread block owns one (b, h, q block) and loops over
// its live slots itself, so padded slots (which alias kv block 0) are never
// read and blocks need no order among themselves.
//
// Bound: 4*BS*BS*D fp32 FLOP per visible block and head on 2*BS*D*4 bytes of
// K and V, so at BS = D = 128 it is bound by fp32 operations.  Everything of
// one q block stays on chip:
//  * Q^T (D x BS, fp32) in shared memory for the whole kv loop;
//  * K streamed through KD-column panels of D (KD = min(32, D), stored
//    transposed), giving the BS x BS score tile in registers: 256 threads as
//    a 16 x 16 grid, thread (ty, tx) owns rows ty + 16*i and columns
//    tx + 16*j;
//  * row max and sum by shuffles among the 16 lanes that share a row, the
//    running max m, sum l and the BS x DO accumulator (rows ty + 16*i,
//    columns tx + 16*j) in registers, in fp32;
//  * the probabilities of one kv block in shared memory (row-major, padded by
//    one word), multiplied by V streamed through KB-row panels
//    (KB = min(32, BS)).
// DO is the block's share of the output's D: all of it up to D = 128; at
// D = 256 a grid axis splits the output into two halves of 128 columns, and
// each block still reduces the scores over the full D (the scores are
// computed twice, the accumulator and V panel stay the size of D = 128's).
// Shared memory is (D + KD + BS) * (BS + 1) + KB * DO floats: 161 KiB at
// BS = D = 128 and 226 KiB at BS = 128, D = 256 (the limit a block may use
// is 227 KiB), above the 48 KiB static limit: the launch opts in to dynamic
// shared memory.  bs in {16, 32, 64, 128}, D in {16, 32, 64, 128, 256}.  Scores and products are IEEE fp32 FMAs and expf/tanhf (no
// TF32, no fast math): the reference holds K3 to 1e-4.  bfloat16 inputs are
// widened on load; the output is rounded to the input type once, on store.
// Rows whose sum is 0 (a q block with no live slot) come out exactly 0.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);

template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the tile shape of one (bs, D): panel depths and the output columns a
// block owns
template <int BS, int D>
struct Shape {
  static constexpr int KD = D < 32 ? D : 32;    // Q K^T panel: columns of D
  static constexpr int KB = BS < 32 ? BS : 32;  // P V panel: kv rows
  static constexpr int DO = D > 128 ? 128 : D;  // output columns per block
  static constexpr int n_split = D / DO;
  static constexpr int smem_floats = (D + KD + BS) * (BS + 1) + KB * DO;
};

template <typename T, int BS, int D>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_ids,
                  const int* __restrict__ n_kv, T* __restrict__ out, int h,
                  int hkv, int nq, int nk_cap, int seq, float scale,
                  float softcap) {
  using S = Shape<BS, D>;
  constexpr int KD = S::KD, KB = S::KB, DO = S::DO;
  constexpr int TM = BS / 16;  // q rows per thread
  constexpr int TN = BS / 16;  // score columns (kv rows) per thread
  constexpr int TD = DO / 16;  // output columns per thread
  constexpr int LD = BS + 1;   // padded row stride of Qt, Kt and Ps
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][LD]   Q^T of this q block
  float* Kt = Qt + D * LD;     // [KD][LD]  K^T panel
  float* Ps = Kt + KD * LD;    // [BS][LD]  probabilities of one kv block
  float* Vs = Ps + BS * LD;    // [KB][DO]  V panel

  const int qi = blockIdx.x;
  const int hi = blockIdx.y / S::n_split;
  const int dcol0 = (blockIdx.y % S::n_split) * DO;  // first output column
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long s_pad = static_cast<long long>(nq) * BS;
  const long long q_off =
      ((static_cast<long long>(bi) * h + hi) * s_pad + static_cast<long long>(qi) * BS) * D;
  const long long kv_off = (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * s_pad * D;

  // Q^T into shared memory, widened to fp32.
  for (int e = tid; e < BS * D / 4; e += kThreads) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const float4 x = load4(q + q_off + r * D + c);
    Qt[(c + 0) * LD + r] = x.x;
    Qt[(c + 1) * LD + r] = x.y;
    Qt[(c + 2) * LD + r] = x.z;
    Qt[(c + 3) * LD + r] = x.w;
  }

  float acc[TM][TD];
  float m_row[TM], l_row[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_row[i] = kNegInf;
    l_row[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.0f;
  }

  const int n = n_kv[qi];
  for (int slot = 0; slot < n; ++slot) {
    const int kb = kv_ids[qi * nk_cap + slot];
    const T* K = k + kv_off + static_cast<long long>(kb) * BS * D;
    const T* V = v + kv_off + static_cast<long long>(kb) * BS * D;

    // S = Q K^T over D in panels of KD.
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KD) {
      __syncthreads();  // Qt is written; earlier readers of Kt and Ps are done
      for (int e = tid; e < BS * KD / 4; e += kThreads) {
        const int r = e / (KD / 4);
        const int c = (e % (KD / 4)) * 4;
        const float4 x = load4(K + r * D + d0 + c);
        Kt[(c + 0) * LD + r] = x.x;
        Kt[(c + 1) * LD + r] = x.y;
        Kt[(c + 2) * LD + r] = x.z;
        Kt[(c + 3) * LD + r] = x.w;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Qt[(d0 + c) * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Kt[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

    // Scale, softcap, mask the padded tail; online softmax update.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (kb * BS + tx + 16 * j >= seq) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_row[i], mx);
      const float alpha = expf(m_row[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_row[i] = l_row[i] * alpha + sum;
      m_row[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }

    // acc += P V over the kv rows in panels of KB, this block's DO columns.
    for (int c0 = 0; c0 < BS; c0 += KB) {
      __syncthreads();  // Ps is written; earlier readers of Vs are done
      for (int e = tid; e < KB * DO / 4; e += kThreads) {
        const int r = e / (DO / 4);
        const int c = (e % (DO / 4)) * 4;
        *reinterpret_cast<float4*>(&Vs[r * DO + c]) =
            load4(V + (c0 + r) * D + dcol0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < KB; ++c) {
        float a[TM], b[TD];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Ps[(ty + 16 * i) * LD + c0 + c];
#pragma unroll
        for (int j = 0; j < TD; ++j) b[j] = Vs[c * DO + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  T* O = out + q_off + dcol0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      store1(O + r * D + tx + 16 * j, l_row[i] > 0.0f ? acc[i][j] / l_row[i] : 0.0f);
  }
}

template <typename T, int BS, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_ids,
           const int* n_kv, void* out, int b, int h, int hkv, int nq,
           int nk_cap, int seq, float scale, float softcap,
           cudaStream_t stream, int device) {
  using S = Shape<BS, D>;
  constexpr int bytes = S::smem_floats * static_cast<int>(sizeof(float));
  static_assert(bytes <= 232448, "above the 227 KiB a block may use");
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, block_attn_kernel<T, BS, D>, bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_attn_kernel<T, BS, D><<<dim3(nq, h * S::n_split, b), kThreads, bytes,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      kv_ids, n_kv, static_cast<T*>(out), h, hkv, nq, nk_cap, seq, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BS>
int launch_d(int d, const void* q, const void* k, const void* v,
             const int* kv_ids, const int* n_kv, void* out, int b, int h,
             int hkv, int nq, int nk_cap, int seq, float scale, float softcap,
             cudaStream_t s, int device) {
  switch (d) {
    case 16: return launch<T, BS, 16>(q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 32: return launch<T, BS, 32>(q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 64: return launch<T, BS, 64>(q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 128: return launch<T, BS, 128>(q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 256: return launch<T, BS, 256>(q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_t(int bs, int d, const void* q, const void* k, const void* v,
             const int* kv_ids, const int* n_kv, void* out, int b, int h,
             int hkv, int nq, int nk_cap, int seq, float scale, float softcap,
             cudaStream_t s, int device) {
  switch (bs) {
    case 16: return launch_d<T, 16>(d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 32: return launch_d<T, 32>(d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 64: return launch_d<T, 64>(d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    case 128: return launch_d<T, 128>(d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches one thread block per (q block, head and output half at d = 256,
// batch) on `stream`.  q and out
// are (b, h, nq*bs, d), k and v (b, hkv, nq*bs, d), all contiguous, 16-byte
// aligned, of one type: dtype 0 = float32, 1 = bfloat16.  kv_ids is
// (nq, nk_cap) and n_kv (nq,), int32, range-checked by the caller.
int block_sparse_attention(const void* q, const void* k, const void* v,
                           const int* kv_ids, const int* n_kv, void* out,
                           int b, int h, int hkv, int nq, int nk_cap, int bs,
                           int d, int seq, float scale, float softcap,
                           int dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(bs, d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(bs, d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
