// Chunked RWKV6 WKV scan (kernel K6) for Hopper, sm_90a.
//
// Per (b, h), over chunks of C tokens, with the (K x V) state S carried in
// order (every exponent below is <= 0: a difference of cumulative log decays,
// never a ratio):
//
//   cum   = inclusive cumsum over the chunk of log w,  ecum = cum - log w
//   o_t   = (r_t * e^{ecum_t}) S                                  inter-chunk
//         + sum_{s<t} (sum_k r_tk k_sk e^{ecum_tk - cum_sk}) v_s   intra-chunk
//         + (r_t . (u * k_t)) v_t                                 bonus
//   S'    = e^{cum_last} * S + sum_s (k_s * e^{cum_last - cum_s})^T v_s
//
// and at the end the final state S.  Replaces the Pallas TPU kernel
// repro.kernels.rwkv6_scan.rwkv6 (src/repro/kernels/rwkv6_scan.py:67,
// pallas_call at :90), which walks the chunks as a sequential grid axis with
// S in VMEM scratch and returns o only; this kernel also writes the final
// state, which the model needs to fill its decode cache at prefill
// (repro.models.ssm.rwkv6_chunked_jnp returns both).
//
// Bound: the Pallas cost estimate's 2*T*K*V + 2*T*C*(K+V) FLOP per (b, h) on
// r, k, w, v read once and o (and the state) written once; at hymba-1.5b's SSM
// heads (K = 16, V = 64, C = 64) both are microseconds.  What limits it is the
// sequential chunk loop, so the design is about parallel width:
//  * one thread block per (b, h, 16-column V tile): at hymba's prefill shape
//    (B = 1, H = 25, V = 64) that is 100 blocks for 132 SMs, where one block
//    per (b, h) would give 25; the C x C intra-chunk matrix A is recomputed
//    by each of the V / 16 tiles of a head (4x at hymba);
//  * per chunk, r, k, log w (then cum), ecum, r * e^{ecum} and
//    k * e^{cum_last - cum} as C x K fp32 arrays in shared memory (rows padded
//    to K + 1 words), the V tile of v, A and the state tile S;
//  * the prefix sums run down the chunk, one thread per k channel;
//  * A[t][s] = sum_k r_tk k_sk e^{ecum_tk - cum_sk} is computed for s < t only:
//    masked entries are skipped by a condition, never by -inf arithmetic
//    (inf - inf would give NaN).
// Shared memory is 6*C*(K+1) + C*16 + C*C + K*16 + C + K floats (48 KiB at
// hymba, 122 KiB at C = K = 64): the launch opts in to dynamic shared memory.
// IEEE fp32 FMAs, expf and logf (no fast math).  r, k, v may be float32 or
// bfloat16 (one type), w float32 or bfloat16, u float32; o and the state are
// float32.  C <= 64 and K <= 64; V is any width (the last tile is masked).
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int VT = 16;  // V columns per block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__host__ __device__ constexpr int smem_floats(int c, int kk) {
  return 6 * c * (kk + 1) + c * VT + c * c + kk * VT + c + kk;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const W* __restrict__ w,
             const float* __restrict__ u, float* __restrict__ o,
             float* __restrict__ state, int h, int t_len, int kk, int vv,
             int c_len) {
  extern __shared__ float smem[];
  const int lk = kk + 1;                  // padded row stride of C x K arrays
  float* Rs = smem;                       // [C][lk] r
  float* Ks = Rs + c_len * lk;            // [C][lk] k
  float* Cum = Ks + c_len * lk;           // [C][lk] log w, then its cumsum
  float* Ecum = Cum + c_len * lk;         // [C][lk] cum - log w
  float* Rq = Ecum + c_len * lk;          // [C][lk] r * e^{ecum}
  float* Kd = Rq + c_len * lk;            // [C][lk] k * e^{cum_last - cum}
  float* Vs = Kd + c_len * lk;            // [C][VT] v tile
  float* A = Vs + c_len * VT;             // [C][C]  intra-chunk weights
  float* S = A + c_len * c_len;           // [K][VT] state tile
  float* Bonus = S + kk * VT;             // [C]     r . (u * k)
  float* Decay = Bonus + c_len;           // [K]     e^{cum_last}

  const int v0 = blockIdx.x * VT;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const long long bh = static_cast<long long>(bi) * h + hi;
  const long long rk_off = bh * t_len * kk;
  const long long v_off = bh * t_len * vv;

  for (int e = tid; e < kk * VT; e += kThreads) S[e] = 0.0f;

  for (int c0 = 0; c0 < t_len; c0 += c_len) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < c_len * kk; e += kThreads) {
      const int t = e / kk;
      const int ch = e % kk;
      const long long g = rk_off + static_cast<long long>(c0 + t) * kk + ch;
      Rs[t * lk + ch] = ld(r + g);
      Ks[t * lk + ch] = ld(k + g);
      Cum[t * lk + ch] = logf(ld(w + g));
    }
    for (int e = tid; e < c_len * VT; e += kThreads) {
      const int t = e / VT;
      const int col = v0 + e % VT;
      Vs[e] = col < vv ? ld(v + v_off + static_cast<long long>(c0 + t) * vv + col)
                       : 0.0f;
    }
    __syncthreads();

    // Inclusive prefix sums of log w down the chunk, one thread per channel.
    for (int ch = tid; ch < kk; ch += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < c_len; ++t) {
        const float lw = Cum[t * lk + ch];
        run += lw;
        Cum[t * lk + ch] = run;
        Ecum[t * lk + ch] = run - lw;
      }
      Decay[ch] = expf(run);
    }
    __syncthreads();

    // A (strictly lower), r * e^{ecum}, k * e^{cum_last - cum}, the bonus.
    for (int e = tid; e < c_len * c_len; e += kThreads) {
      const int t = e / c_len;
      const int s = e % c_len;
      float a = 0.0f;
      if (s < t) {
        const float* rt = Rs + t * lk;
        const float* et = Ecum + t * lk;
        const float* ks = Ks + s * lk;
        const float* cs = Cum + s * lk;
        for (int ch = 0; ch < kk; ++ch)
          a = fmaf(rt[ch] * ks[ch], expf(et[ch] - cs[ch]), a);
      }
      A[e] = a;
    }
    const float* last = Cum + (c_len - 1) * lk;
    for (int e = tid; e < c_len * kk; e += kThreads) {
      const int t = e / kk;
      const int ch = e % kk;
      Rq[t * lk + ch] = Rs[t * lk + ch] * expf(Ecum[t * lk + ch]);
      Kd[t * lk + ch] = Ks[t * lk + ch] * expf(last[ch] - Cum[t * lk + ch]);
    }
    for (int t = tid; t < c_len; t += kThreads) {
      float b = 0.0f;
      for (int ch = 0; ch < kk; ++ch)
        b = fmaf(Rs[t * lk + ch] * u[hi * kk + ch], Ks[t * lk + ch], b);
      Bonus[t] = b;
    }
    __syncthreads();

    // o = (r * e^{ecum}) S + A v + bonus * v, with the state before the carry.
    for (int e = tid; e < c_len * VT; e += kThreads) {
      const int t = e / VT;
      const int j = e % VT;
      float inter = 0.0f;
      for (int ch = 0; ch < kk; ++ch)
        inter = fmaf(Rq[t * lk + ch], S[ch * VT + j], inter);
      float intra = 0.0f;
      for (int s = 0; s < t; ++s) intra = fmaf(A[t * c_len + s], Vs[s * VT + j], intra);
      const int col = v0 + j;
      if (col < vv)
        o[v_off + static_cast<long long>(c0 + t) * vv + col] =
            inter + intra + Bonus[t] * Vs[t * VT + j];
    }
    __syncthreads();

    // State carry: S' = e^{cum_last} * S + Kd^T v.
    for (int e = tid; e < kk * VT; e += kThreads) {
      const int ch = e / VT;
      const int j = e % VT;
      float acc = 0.0f;
      for (int s = 0; s < c_len; ++s)
        acc = fmaf(Kd[s * lk + ch], Vs[s * VT + j], acc);
      S[e] = Decay[ch] * S[e] + acc;
    }
  }

  __syncthreads();
  for (int e = tid; e < kk * VT; e += kThreads) {
    const int col = v0 + e % VT;
    if (col < vv)
      state[(bh * kk + e / VT) * vv + col] = S[e];
  }
}

template <typename T, typename W>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, float* o, float* state, int b, int h, int t_len,
           int kk, int vv, int c_len, cudaStream_t stream) {
  const int bytes = smem_floats(c_len, kk) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((vv + VT - 1) / VT, h, b);
  rwkv6_kernel<T, W><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const W*>(w), u, o, state, h, t_len, kk, vv, c_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(int w_dtype, const void* r, const void* k, const void* v,
             const void* w, const float* u, float* o, float* state, int b,
             int h, int t_len, int kk, int vv, int c_len, cudaStream_t s) {
  if (w_dtype == 0)
    return launch<T, float>(r, k, v, w, u, o, state, b, h, t_len, kk, vv, c_len, s);
  if (w_dtype == 1)
    return launch<T, __nv_bfloat16>(r, k, v, w, u, o, state, b, h, t_len, kk, vv, c_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches one thread block per (16-column V tile, head, batch) on `stream`.
// r, k, w are (b, h, t_len, kk), v (b, h, t_len, vv), u (h, kk) float32, o
// (b, h, t_len, vv) and state (b, h, kk, vv) float32, all contiguous.  dtype
// is the type of r, k and v, w_dtype that of w: 0 = float32, 1 = bfloat16.
// The caller checks t_len % c_len == 0, c_len <= 64 and kk <= 64.
int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
               const float* u, float* o, float* state, int b, int h,
               int t_len, int kk, int vv, int c_len, int dtype, int w_dtype,
               void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_w<float>(w_dtype, r, k, v, w, u, o, state, b, h, t_len, kk, vv, c_len, s);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(w_dtype, r, k, v, w, u, o, state, b, h, t_len, kk, vv, c_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
