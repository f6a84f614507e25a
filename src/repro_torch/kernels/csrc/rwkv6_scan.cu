// Chunked RWKV6 WKV scan (kernel K6) for Hopper, sm_90a.
//
// Per (b, h), over chunks of C tokens, with the (K x V) state S carried from
// chunk to chunk (every exponent below is <= 0: a difference of cumulative
// log decays, never a ratio):
//
//   cum   = inclusive cumsum over the chunk of log w,  ecum = cum - log w
//   o_t   = (r_t * e^{ecum_t}) S_{c-1}                            inter-chunk
//         + sum_{s<t} (sum_k r_tk k_sk e^{ecum_tk - cum_sk}) v_s   intra-chunk
//         + (r_t . (u * k_t)) v_t                                 bonus
//   S_c   = e^{cum_last} * S_{c-1} + sum_s (k_s * e^{cum_last - cum_s})^T v_s
//
// and at the end the final state.  Replaces the Pallas TPU kernel
// repro.kernels.rwkv6_scan.rwkv6 (src/repro/kernels/rwkv6_scan.py:67,
// pallas_call at :90), which walks the chunks as a sequential grid axis with
// S in VMEM scratch and returns o only; this kernel also writes the final
// state, which the model needs to fill its decode cache at prefill
// (repro.models.ssm.rwkv6_chunked_jnp returns both).
//
// Bound: the Pallas cost estimate's 2*T*K*V + 2*T*C*(K+V) FLOP per (b, h) on
// r, k, w, v read once and o and the state written once; at hymba-1.5b's SSM
// heads (K = 16, V = 64, C = 64) both are microseconds.  A walk over the
// chunks in order inside one block per head is latency: dozens of dependent
// barriers and serial sums per chunk.  Only the state carry is sequential,
// and it is linear (S_c = diag(d_c) S_{c-1} + U_c), so the chunk axis runs in
// parallel, in three launches on one stream:
//  1. chunk_local, one block per (b, h, chunk): the chunk's prefix sums of
//     log w (in token order, as the plain version sums them); A, strictly
//     lower, never masked by -inf arithmetic (inf - inf would give NaN):
//     inside each 16-token sub-block one exponential per (t, s, k), across
//     sub-blocks a product of two factor matrices whose exponents are both
//     <= 0 (below); r * e^{ecum}, k * e^{cum_last - cum} and the bonus, once
//     per head.  It writes the state-free part of o (A v + bonus * v, 4 x 4
//     outputs a thread), and to scratch r * e^{ecum} (C x K), the chunk's
//     decay d_c = e^{cum_last} (K) and its contribution U_c = Kd^T v (K x V);
//  2. state_scan, one thread per (b, h, state element): loads U_c and d_c of
//     8 chunks at a time (they do not depend on S), then applies the 8
//     dependent FMAs in registers; it overwrites U_c in place with the state
//     that enters chunk c, and writes the final state;
//  3. inter_chunk, one block per (b, h, chunk > 0): o += (r e^{ecum}) S_{c-1},
//     4 x 4 outputs a thread.
// Scratch (the caller's, float32): B*H*T*K + B*H*NC*K + B*H*NC*K*V floats.
// IEEE fp32 FMAs, expf and logf (no fast math).  r, k, v may be float32 or
// bfloat16 (one type), w float32 or bfloat16, u float32; o and the state are
// float32.  C <= 64 and K <= 64; V is any width (the last tile is masked).
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of an attribute call or a launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int VT = 64;       // V columns per tile of chunk_local / inter_chunk
constexpr int kScanBatch = 8;  // chunks whose loads state_scan issues at once

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// chunk_local splits a chunk into sub-blocks of SB tokens.  For t in
// sub-block b and s in an earlier one, with ref_b = cum at token SB*b - 1,
//   e^{ecum_t - cum_s} = e^{ecum_t - ref_b} * e^{ref_b - cum_s},
// both exponents <= 0 (ecum_t = cum_{t-1} <= ref_b <= cum_s), so A's
// entries across sub-blocks are a product of two factor matrices; only the
// pairs inside a sub-block take an exponential each.  At C = 64 that is
// about a third of C(C-1)/2 * K exponentials.
constexpr int SB = 16;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// rows of the k-side factors, sum over sub-blocks b >= 1 of SB * b
__host__ __device__ constexpr int kf_rows(int c) {
  return SB * ((c + SB - 1) / SB) * ((c + SB - 1) / SB - 1) / 2;
}
// shared memory of chunk_local: A transposed, At[s][t] (row stride LA = C
// rounded up to 4); a v tile C x VT; r (then its factor), k (then kd), cum,
// ecum as C x (K + 1); the k-side factors; cum_last (K)
__host__ __device__ constexpr int local_smem_floats(int c, int kk) {
  return c * round4(c) + c * VT + (4 * c + kf_rows(c)) * (kk + 1) + kk;
}

// KT: K as a compile-time constant (16, hymba's SSM state, or 64), or 0 for
// any other K <= 64, read from kk_rt; a constant K makes the index
// arithmetic shifts.
template <typename T, typename W, int KT>
__global__ void __launch_bounds__(kThreads)
chunk_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const W* __restrict__ w,
                   const float* __restrict__ u, float* __restrict__ o,
                   float* __restrict__ rq, float* __restrict__ decay,
                   float* __restrict__ contrib, int h, int t_len, int kk_rt,
                   int vv, int c_len) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KT ? KT : kk_rt;
  const int lk = kk + 1;                  // padded row stride of C x K arrays
  const int la = round4(c_len);           // row stride of At
  float* At = smem;                       // [C][la] A^T, bonus on the diagonal
  float* Vs = At + c_len * la;            // [C][VT] v tile
  float* Rs = Vs + c_len * VT;            // [C][lk] r, then r e^{ecum - ref}
  float* Ks = Rs + c_len * lk;            // [C][lk] k, then k e^{last - cum}
  float* Cum = Ks + c_len * lk;           // [C][lk] log w, then its cumsum
  float* Ecum = Cum + c_len * lk;         // [C][lk] cum - log w
  float* Kf = Ecum + c_len * lk;          // [kf_rows][lk] k_s e^{ref_b - cum_s}
  float* Last = Kf + kf_rows(c_len) * lk; // [K] cum_last

  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const long long bh = static_cast<long long>(bi) * h + hi;
  const long long c0 = static_cast<long long>(ci) * c_len;
  const long long rk_off = (bh * t_len + c0) * kk;
  const long long v_off = (bh * t_len + c0) * vv;
  const int n_sb = (c_len + SB - 1) / SB;

  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    Rs[t * lk + ch] = ld(r + rk_off + e);
    Ks[t * lk + ch] = ld(k + rk_off + e);
    Cum[t * lk + ch] = logf(ld(w + rk_off + e));
  }
  __syncthreads();

  // Inclusive prefix sums of log w down the chunk, one thread per channel, in
  // token order: the order of the plain version's cumsum.  The exponents
  // below are differences of these sums, so at decays near 1e-6 (|cum| in the
  // hundreds) a tree-ordered scan's other rounding moved o by up to 7e-4
  // against the plain version; the serial sum costs C dependent adds.
  for (int ch = tid; ch < kk; ch += kThreads) {
    float run = 0.0f;
#pragma unroll 8
    for (int t = 0; t < c_len; ++t) {
      const float lw = Cum[t * lk + ch];
      run += lw;
      Cum[t * lk + ch] = run;
      Ecum[t * lk + ch] = run - lw;
    }
    Last[ch] = run;
    decay[(bh * nc + ci) * kk + ch] = expf(run);
  }
  __syncthreads();

  // A^T inside each sub-block (pairs s < t, p = t' (t' - 1) / 2 + s' in
  // sub-block coordinates); r e^{ecum} to scratch; the k-side factors of
  // every later sub-block.
  const int sb_pairs = SB * (SB - 1) / 2;
  for (int p = tid; p < n_sb * sb_pairs; p += kThreads) {
    const int b = p / sb_pairs;
    const int q = p % sb_pairs;
    int tl = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * q)) * 0.5f);
    while (tl * (tl - 1) / 2 > q) --tl;
    while ((tl + 1) * tl / 2 <= q) ++tl;
    const int t = SB * b + tl;
    const int s = SB * b + q - tl * (tl - 1) / 2;
    if (t >= c_len) continue;
    const float* rt = Rs + t * lk;
    const float* et = Ecum + t * lk;
    const float* ks = Ks + s * lk;
    const float* cs = Cum + s * lk;
    float a = 0.0f;
    for (int ch = 0; ch < kk; ++ch)
      a = fmaf(rt[ch] * ks[ch], expf(et[ch] - cs[ch]), a);
    At[s * la + t] = a;
  }
  // the diagonal 4 x 4 blocks of At that the o tile reads: the bonus on the
  // diagonal, zeros above it (s > t)
  for (int e = tid; e < c_len * 4; e += kThreads) {
    const int s = e / 4;
    const int t = (s & ~3) + e % 4;
    if (t == s) {
      float b = 0.0f;
      for (int ch = 0; ch < kk; ++ch)
        b = fmaf(Rs[t * lk + ch] * u[hi * kk + ch], Ks[t * lk + ch], b);
      At[s * la + t] = b;
    } else if (t < s) {
      At[s * la + t] = 0.0f;
    }
  }
  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    rq[rk_off + e] = Rs[t * lk + ch] * expf(Ecum[t * lk + ch]);
  }
  for (int e = tid; e < kf_rows(c_len) * kk; e += kThreads) {
    const int row = e / kk;             // rows of sub-block b start at SB b (b - 1) / 2
    const int ch = e % kk;
    int b = 1;
    while (SB * (b + 1) * b / 2 <= row) ++b;
    const int s = row - SB * b * (b - 1) / 2;
    const float ref = Cum[(SB * b - 1) * lk + ch];
    Kf[row * lk + ch] = Ks[s * lk + ch] * expf(ref - Cum[s * lk + ch]);
  }
  __syncthreads();

  // In place: r e^{ecum - ref_b} (ref_0 = 0: r e^{ecum}), k e^{last - cum}.
  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    const int b = t / SB;
    const float ref = b ? Cum[(SB * b - 1) * lk + ch] : 0.0f;
    Rs[t * lk + ch] *= expf(Ecum[t * lk + ch] - ref);
    Ks[t * lk + ch] *= expf(Last[ch] - Cum[t * lk + ch]);
  }
  __syncthreads();

  // A^T across sub-blocks: A[t][s] = sum_k Rf[t][k] Kf_b[s][k] for t in
  // sub-block b and s < SB b; one (s, t) pair an item.
  for (int e = tid; e < kf_rows(c_len) * SB; e += kThreads) {
    const int row = e / SB;
    int b = 1;
    while (SB * (b + 1) * b / 2 <= row) ++b;
    const int s = row - SB * b * (b - 1) / 2;
    const int t = SB * b + e % SB;
    if (t >= c_len) continue;
    const float* kf = Kf + row * lk;
    const float* rf = Rs + t * lk;
    float a = 0.0f;
    for (int ch = 0; ch < kk; ++ch) a = fmaf(rf[ch], kf[ch], a);
    At[s * la + t] = a;
  }

  float* U = contrib + (bh * nc + ci) * kk * vv;
  const int ty = tid / (VT / 4);          // 4 rows of the o tile: 4 ty + [0, 4)
  const int j4 = (tid % (VT / 4)) * 4;    // its 4 columns: j4 + [0, 4)
  for (int v0 = 0; v0 < vv; v0 += VT) {
    __syncthreads();  // At, Kd are written; the last tile's readers are done
    for (int e = tid; e < c_len * VT; e += kThreads) {
      const int t = e / VT;
      const int col = v0 + e % VT;
      Vs[e] = col < vv ? ld(v + v_off + static_cast<long long>(t) * vv + col)
                       : 0.0f;
    }
    __syncthreads();
    // the state-free part of o, (A + diag(bonus)) v: a 4 x 4 tile a thread
    for (int t0 = 4 * ty; t0 < c_len; t0 += 4 * (kThreads / (VT / 4))) {
      float acc[4][4] = {};
      const int s_end = min(t0 + 4, c_len);
      for (int s = 0; s < s_end; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(At + s * la + t0);
        const float4 x = *reinterpret_cast<const float4*>(Vs + s * VT + j4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (t0 + i >= c_len) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v0 + j4 + j < vv)
            o[v_off + static_cast<long long>(t0 + i) * vv + v0 + j4 + j] =
                acc[i][j];
      }
    }
    // the chunk's contribution to the state, Kd^T v: a 1 x 4 tile a thread
    for (int e = tid; e < kk * (VT / 4); e += kThreads) {
      const int ch = e / (VT / 4);
      const int jj = (e % (VT / 4)) * 4;
      float acc[4] = {};
      for (int s = 0; s < c_len; ++s) {
        const float kd = Ks[s * lk + ch];
        const float4 x = *reinterpret_cast<const float4*>(Vs + s * VT + jj);
        acc[0] = fmaf(kd, x.x, acc[0]);
        acc[1] = fmaf(kd, x.y, acc[1]);
        acc[2] = fmaf(kd, x.z, acc[2]);
        acc[3] = fmaf(kd, x.w, acc[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + jj + j < vv) U[ch * vv + v0 + jj + j] = acc[j];
    }
  }
}

// One thread per (b, h, state element e = ch * V + col): S = d_c[ch] S + U_c[e]
// over the chunks, U_c replaced by the state entering chunk c.
__global__ void __launch_bounds__(kThreads)
state_scan_kernel(const float* __restrict__ decay, float* __restrict__ contrib,
                  float* __restrict__ state, int kk, int vv, int nc) {
  const int kv = kk * vv;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= kv) return;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int ch = e / vv;
  float* U = contrib + bh * nc * kv + e;
  const float* D = decay + bh * nc * kk + ch;
  float s = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
    float uc[kScanBatch], dc[kScanBatch];
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      const bool in = c0 + i < nc;
      uc[i] = in ? U[static_cast<long long>(c0 + i) * kv] : 0.0f;
      dc[i] = in ? D[static_cast<long long>(c0 + i) * kk] : 1.0f;
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c0 + i < nc) U[static_cast<long long>(c0 + i) * kv] = s;
      s = fmaf(dc[i], s, uc[i]);
    }
  }
  state[bh * kv + e] = s;
}

// o[chunk c] += (r e^{ecum}) S_{c-1}, for chunks c >= 1 (blockIdx.x = c - 1).
template <int KT>
__global__ void __launch_bounds__(kThreads)
inter_chunk_kernel(const float* __restrict__ rq,
                   const float* __restrict__ s_in, float* __restrict__ o,
                   int h, int t_len, int kk_rt, int vv, int c_len, int nc) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KT ? KT : kk_rt;
  const int lk = kk + 1;
  float* Rq = smem;                  // [C][lk]
  float* Ss = Rq + round4(c_len * lk);  // [K][VT], 16-byte aligned
  const int ci = blockIdx.x + 1;
  const long long bh = static_cast<long long>(blockIdx.z) * h + blockIdx.y;
  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(ci) * c_len;
  const float* R = rq + (bh * t_len + c0) * kk;
  const float* S = s_in + (bh * nc + ci) * kk * vv;
  float* O = o + (bh * t_len + c0) * vv;
  for (int e = tid; e < c_len * kk; e += kThreads)
    Rq[(e / kk) * lk + e % kk] = R[e];
  const int ty = tid / (VT / 4);          // 4 rows of the tile: 4 ty + [0, 4)
  const int j4 = (tid % (VT / 4)) * 4;    // its 4 columns: j4 + [0, 4)
  for (int v0 = 0; v0 < vv; v0 += VT) {
    __syncthreads();  // Rq is written; the last tile's readers are done
    for (int e = tid; e < kk * VT; e += kThreads) {
      const int col = v0 + e % VT;
      Ss[e] = col < vv ? S[(e / VT) * vv + col] : 0.0f;
    }
    __syncthreads();
    for (int t0 = 4 * ty; t0 < c_len; t0 += 4 * (kThreads / (VT / 4))) {
      // this thread's o entries first, so their loads overlap the products
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = v0 + j4 + j;
          acc[i][j] = t0 + i < c_len && col < vv
                          ? O[static_cast<long long>(t0 + i) * vv + col]
                          : 0.0f;
        }
      for (int ch = 0; ch < kk; ++ch) {
        const float4 x = *reinterpret_cast<const float4*>(Ss + ch * VT + j4);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float rv = t0 + i < c_len ? Rq[(t0 + i) * lk + ch] : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(rv, xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (t0 + i >= c_len) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v0 + j4 + j < vv)
            O[static_cast<long long>(t0 + i) * vv + v0 + j4 + j] = acc[i][j];
      }
    }
  }
}

template <typename T, typename W, int KT>
int launch_k(const void* r, const void* k, const void* v, const void* w,
           const float* u, float* o, float* state, float* scratch, int b,
           int h, int t_len, int kk, int vv, int c_len, cudaStream_t stream,
           int device) {
  const int nc = t_len / c_len;
  float* rq = scratch;
  float* decay = rq + static_cast<long long>(b) * h * t_len * kk;
  float* contrib = decay + static_cast<long long>(b) * h * nc * kk;

  const int local_bytes =
      local_smem_floats(c_len, kk) * static_cast<int>(sizeof(float));
  static std::atomic<int> smem_set[64];  // zero: static storage
  cudaError_t err =
      allow_smem(smem_set, chunk_local_kernel<T, W, KT>, local_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_local_kernel<T, W, KT><<<dim3(nc, h, b), kThreads, local_bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const W*>(w), u, o, rq, decay,
      contrib, h, t_len, kk, vv, c_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  state_scan_kernel<<<dim3((kk * vv + kThreads - 1) / kThreads, h, b),
                      kThreads, 0, stream>>>(decay, contrib, state, kk, vv,
                                             nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return static_cast<int>(err);

  const int inter_bytes =
      (round4(c_len * (kk + 1)) + kk * VT) * static_cast<int>(sizeof(float));
  inter_chunk_kernel<KT><<<dim3(nc - 1, h, b), kThreads, inter_bytes, stream>>>(
      rq, contrib, o, h, t_len, kk, vv, c_len, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, float* o, float* state, float* scratch, int b,
           int h, int t_len, int kk, int vv, int c_len, cudaStream_t s,
           int device) {
  switch (kk) {
    case 16: return launch_k<T, W, 16>(r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
    case 64: return launch_k<T, W, 64>(r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
    default: return launch_k<T, W, 0>(r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
  }
}

template <typename T>
int launch_w(int w_dtype, const void* r, const void* k, const void* v,
             const void* w, const float* u, float* o, float* state,
             float* scratch, int b, int h, int t_len, int kk, int vv,
             int c_len, cudaStream_t s, int device) {
  if (w_dtype == 0)
    return launch<T, float>(r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
  if (w_dtype == 1)
    return launch<T, __nv_bfloat16>(r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Runs K6's three launches on `stream`.  r, k, w are (b, h, t_len, kk), v
// (b, h, t_len, vv), u (h, kk) float32, o (b, h, t_len, vv) and state
// (b, h, kk, vv) float32, all contiguous; scratch holds
// b*h*(t_len*kk + nc*kk + nc*kk*vv) float32 (nc = t_len / c_len).  dtype is
// the type of r, k and v, w_dtype that of w: 0 = float32, 1 = bfloat16.  The
// caller checks t_len % c_len == 0, c_len <= 64 and kk <= 64.
int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
               const float* u, float* o, float* state, float* scratch, int b,
               int h, int t_len, int kk, int vv, int c_len, int dtype,
               int w_dtype, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_w<float>(w_dtype, r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(w_dtype, r, k, v, w, u, o, state, scratch, b, h, t_len, kk, vv, c_len, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
