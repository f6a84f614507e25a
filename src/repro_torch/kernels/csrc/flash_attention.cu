// Causal / sliding-window flash attention (kernel K4) for Hopper, sm_90a.
//
//   out[b, h, i] = softmax_j(mask(i, j) ? softcap(q_i . k_j * scale) : -) @ v
//   mask(i, j)   = j < seq  and (not causal or j <= i)
//                           and (window == 0 or j > i - window)
//   kv head      = h / (H / Hkv)
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:116, pallas_call at :164).  The TPU
// version reads the visible kv range of each q block from a host schedule
// (attention_block_schedule, :49) by scalar prefetch and walks it as a
// sequential grid axis with the running max, sum and accumulator in VMEM.
// Here one thread block owns one (b, h, 64-row q tile), computes the same
// closed-form range for its tile itself (no schedule upload), and loops over
// the range's 64-row kv tiles; the causal, window and tail masks are applied
// per element.  Blocks need no order among themselves.
//
// Bound: 4 * D FLOP per visible (q, k) pair on q, k, v read once and the output
// written once; at hymba-1.5b's prefill (D = 64, window 1024, S = 2048) that is
// 10 GFLOP on 16 MB in bfloat16, bound by operations.  This first version is
// K3's inner loop (csrc/block_sparse_attention.cu) on 64 x 64 tiles, kept on
// chip:
//  * Q^T (D x 64, fp32) in shared memory for the whole kv loop;
//  * K streamed through 32-column panels of D (stored transposed), giving the
//    64 x 64 score tile in registers: 256 threads as a 16 x 16 grid, thread
//    (ty, tx) owns rows ty + 16*i and columns tx + 16*j;
//  * row max and sum by shuffles among the 16 lanes that share a row, the
//    running max m, sum l and the 64 x D accumulator in registers, in fp32;
//    a masked entry gets probability 0 by a condition (no -inf arithmetic), so
//    a row whose first tiles are all masked carries m = -1e30, l = 0, acc = 0;
//  * the probabilities of one kv tile in shared memory, multiplied by V
//    streamed through 32-row panels.
// Ragged S: q rows >= seq load as 0 and are never stored; kv rows >= seq load
// as 0 and are masked.  Shared memory is (D + 32 + 64) * 65 + 32 * D floats
// (49.8 KiB at D = 64, 74.6 KiB at D = 128), above the 48 KiB static limit: the
// launch opts in to dynamic shared memory.  Scores and products are IEEE fp32
// FMAs and expf/tanhf (no TF32, no fast math).  bfloat16 inputs are widened on
// load; the output is rounded to the input type once, on store.  Rows whose
// sum is 0 come out exactly 0.  Tensor cores (wgmma) are later work.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // kv rows per tile
constexpr int KP = 32;  // panel depth: columns of D for Q K^T, kv rows for P V
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

template <int D>
constexpr int smem_floats() {
  return (D + KP + BQ) * (BK + 1) + KP * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int h, int hkv,
                  int seq, int causal, int window, float scale, float softcap) {
  constexpr int TM = BQ / 16;  // q rows per thread
  constexpr int TN = BK / 16;  // score columns (kv rows) per thread
  constexpr int TD = D / 16;   // output columns per thread
  constexpr int LD = BK + 1;   // padded row stride of Qt, Kt and Ps (BQ == BK)
  static_assert(BQ == BK, "Qt shares the padded stride of Kt and Ps");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][LD]   Q^T of this q tile
  float* Kt = Qt + D * LD;     // [KP][LD]  K^T panel
  float* Ps = Kt + KP * LD;    // [BQ][LD]  probabilities of one kv tile
  float* Vs = Ps + BQ * LD;    // [KP][D]   V panel

  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long q_off = (static_cast<long long>(bi) * h + hi) * seq * D;
  const long long kv_off =
      (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * seq * D;

  // Q^T into shared memory, widened to fp32; rows past seq are 0.
  for (int e = tid; e < BQ * D / 4; e += kThreads) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const float4 x = q0 + r < seq
        ? load4(q + q_off + static_cast<long long>(q0 + r) * D + c)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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

  // The visible kv tiles of this q tile: attention_block_schedule's closed
  // form at bq = bk = 64, with the last q row clipped to seq.
  const int q_last = min(q0 + BQ, seq) - 1;
  const int kv_hi = causal ? q_last / BK + 1 : (seq + BK - 1) / BK;
  int kv_lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kv_lo = first > 0 ? first / BK : 0;
  }

  for (int kb = kv_lo; kb < kv_hi; ++kb) {
    const int k0 = kb * BK;

    // S = Q K^T over D in panels of KP.
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KP) {
      __syncthreads();  // Qt is written; earlier readers of Kt and Ps are done
      for (int e = tid; e < BK * KP / 4; e += kThreads) {
        const int r = e / (KP / 4);
        const int c = (e % (KP / 4)) * 4;
        const float4 x = k0 + r < seq
            ? load4(k + kv_off + static_cast<long long>(k0 + r) * D + d0 + c)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        Kt[(c + 0) * LD + r] = x.x;
        Kt[(c + 1) * LD + r] = x.y;
        Kt[(c + 2) * LD + r] = x.z;
        Kt[(c + 3) * LD + r] = x.w;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < KP; ++c) {
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

    // Scale, softcap, then the masks; online softmax update.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
      unsigned live = 0u;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos < seq && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        if (ok) {
          live |= 1u << j;
          mx = fmaxf(mx, x);
        }
        s[i][j] = x;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_row[i], mx);
      const float alpha = expf(m_row[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = (live >> j) & 1u ? expf(s[i][j] - m_new) : 0.0f;
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

    // acc += P V over the kv rows in panels of KP.
    for (int c0 = 0; c0 < BK; c0 += KP) {
      __syncthreads();  // Ps is written; earlier readers of Vs are done
      for (int e = tid; e < KP * D / 4; e += kThreads) {
        const int r = e / (D / 4);
        const int c = (e % (D / 4)) * 4;
        const int row = k0 + c0 + r;
        *reinterpret_cast<float4*>(&Vs[r * D + c]) = row < seq
            ? load4(v + kv_off + static_cast<long long>(row) * D + c)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        float a[TM], b[TD];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Ps[(ty + 16 * i) * LD + c0 + c];
#pragma unroll
        for (int j = 0; j < TD; ++j) b[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  T* O = out + q_off;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      store1(O + static_cast<long long>(r) * D + tx + 16 * j,
             l_row[i] > 0.0f ? acc[i][j] / l_row[i] : 0.0f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int hkv, int seq, int causal, int window, float scale,
           float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, h, b);
  flash_attn_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), h, hkv, seq, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int b, int h, int hkv, int seq, int causal, int window,
             float scale, float softcap, cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s);
    case 128: return launch<T, 128>(q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches one thread block per (64-row q tile, head, batch) on `stream`.  q
// and out are (b, h, seq, d), k and v (b, hkv, seq, d), all contiguous,
// 16-byte aligned, of one type: dtype 0 = float32, 1 = bfloat16; d is 64 or
// 128 and h a multiple of hkv (checked by the caller).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int h, int hkv, int seq, int d, int causal,
                    int window, float scale, float softcap, int dtype,
                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
