// The backward of the chunked RWKV6 WKV scan (kernel K6) for Hopper, sm_90a.
//
// Forward (csrc/rwkv6_scan.cu), per (b, h) and chunk c of C tokens, with
// cum the inclusive cumsum of log w over the chunk, ecum = cum - log w, L the
// chunk's last cum and S_{c-1} the (K x V) state entering the chunk:
//   o_t  = (r_t e^{ecum_t}) S_{c-1} + sum_{s<t} A_ts v_s + (r_t . (u k_t)) v_t
//   A_ts = sum_k r_tk k_sk e^{ecum_tk - cum_sk}
//   S_c  = e^{L} S_{c-1} + (k e^{L - cum})^T v
// Backward, given do (B,H,T,V) and dstate (the final state's cotangent, or
// none), with dA_ts = do_t . v_s and db_t = do_t . v_t:
//   G_c  = dLoss/dS_c:  G_{NC-1} = dstate (or 0),  G_{c-1} = e^{L_c} G_c + Q_c,
//          Q_c = (r e^{ecum})^T do
//   dr_t = sum_{s<t} dA_ts k_s e^{ecum_t - cum_s} + e^{ecum_t} (do_t S_{c-1}^T)
//          + u k_t db_t
//   dk_s = sum_{t>s} dA_ts r_t e^{ecum_t - cum_s} + e^{L - cum_s} (v_s G_c^T)
//          + u r_s db_s
//   dv_s = sum_{t>s} A_ts do_t + (r_s . (u k_s)) do_s + (k_s e^{L - cum_s}) G_c
//   du   = sum over b and t of r_t k_t db_t
//   dw_j = the sum of the pair terms r_t k_s e^{sum_{s<i<t} log w_i} (do_t . v_s)
//          whose span s < j < t holds j (a t past the end is the final state
//          against dstate), each with its factor w_j left out.
//
// dw without a division by w.  The textbook route, dlogw_j = sum_{t>j} r dr
// - sum_{s>=j} k dk (without the bonus terms) and dw = dlogw / w, is what
// autograd of the plain version computes: two sums of order one whose
// difference is of order w_j, so their float32 rounding, divided by w_j,
// swamps dw where w is small (about 1e-2 in relative norm against float64 at
// random decays; tests/test_torch_rwkv6_bwd.py).  Every pair whose span
// holds j carries w_j itself, so dw_j is summed with it left out, in three
// parts whose exponents are all <= 0:
//   intra:    sum_{t>j} r_t e^{ecum_t - cum_j} M_j[t],   M_0 = 0,
//             M_{j+1}[t] = w_j M_j[t] + e^{ecum_{j+1} - cum_j} dA_tj k_j;
//   later tokens against the entering state:  e^{ecum_j} Y_j,  Y_{C-1} = 0,
//             Y_{j-1} = w_j Y_j + e^{ecum_j - cum_{j-1}} r_j (do_j S_{c-1}^T);
//   this and earlier chunks against later ones:  e^{L - cum_j} Z_j,
//             Z_0 = sum_v S_{c-1} G_c,
//             Z_{j+1} = w_j Z_j + e^{ecum_{j+1} - cum_j} k_j (v_j G_c^T).
//
// Replaces the XLA autodiff of the reference's rwkv6_chunked_jnp
// (src/repro/models/ssm.py:17), which its models train through
// (src/repro/models/blocks.py:372, :437, :574): the reference has no
// backward Pallas kernel, so there is no pallas_call to name.
//
// Bound: per (b, h) some 3 T C K FLOP for A, dr and dk inside the chunks,
// 2 T C V for dA and A^T do, 10 T K V for Q, U, the inter-chunk terms and
// (k e^{L-cum}) G (dw then needs O(T K)), at the peak of r, k and v's type,
// against r, k, v, w, u and do read once and dr, dk, dv, dw and du written
// once (3.35 TB/s): with bfloat16 r, k, v, as the models train, it is bound
// by bytes at both training shapes.  This first kernel runs IEEE fp32 FMAs,
// expf and logf (no fast math), and spends 2 T C K more than the function
// needs on dw's intra recurrence; the tensor cores are later work.
//
// Four launches on one stream, as the forward's three plus one:
//  1. bwd_local, one block per (chunk, h, b): the chunk's prefix sums of log w
//     in token order (the forward's order and bits); A^T with the bonus on its
//     diagonal, then over tiles of V: dA and db (stored below A^T's diagonal),
//     dv's intra and bonus part A^T do; dr's and dk's intra parts, one
//     exponential per (t, s, k); dw's intra part, a warp per channel with the
//     lanes over t; db and the chunk's share of du; then Q_c and U_c, the
//     forward's contribution to the state, in the forward's summation order.
//  2. bwd_scan, one thread per (b, h, state element): the forward's scan
//     again, U_c replaced by the state entering chunk c; then the reverse
//     scan, Q_c replaced by G_c.  The states are recomputed, not saved by the
//     forward: the chunk-local pass forms U_c beside Q_c from the same loads
//     (one more C x K x V product a chunk), so the forward under grad is the
//     no-grad call as it is, keeps nothing, and the backward takes the
//     forward's inputs only.  Saving them would hold B H NC K V floats (33.5
//     MB at rwkv6-1.6b's B 2 x T 2048) from a layer's forward to its
//     backward and drop U_c and this kernel's first half; chip_smoke.py's
//     training-step profiles time bwd_scan (port_kernel_names_us), and
//     PERF.md section 6 weighs the saving against it.
//  3. bwd_inter, one block per (chunk, h, b): over tiles of V, do S_{c-1}^T,
//     v G_c^T and (k e^{L - cum}) G_c; then dr, dk and dv with every part and
//     dw's two recurrences, one thread per channel.
//  4. bwd_du, one thread per (h, k): du summed over b, then over chunks.
// No atomics: each output and partial sum has one writer and a fixed order,
// so two runs are bit-identical.  Pairs s >= t are never visited (no -inf
// arithmetic).  Scratch (the caller's, float32):
//   B H (NC K (1 + 2 V) + T (3 K + V + 1) + NC K) floats.
// r, k, v may be float32 or bfloat16 (one type), w float32 or bfloat16, u, do
// and dstate float32; dr, dk, dv come in r's type, dw in w's, du float32.
// C <= 64 and K <= 64; V is any width (tiles of 32 columns, the last masked).
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of an attribute call or a launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int VT = 32;          // V columns per tile
constexpr int LV = VT + 1;      // padded row stride of a tile
constexpr int kScanBatch = 8;   // chunks whose loads bwd_scan issues at once
constexpr int kMaxC = 64;
constexpr int kMaxK = 64;
// (t, k) entries of a chunk that one thread of bwd_inter owns, at most
constexpr int kEntries = kMaxC * kMaxK / kThreads;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// r, k and log w of one chunk into shared memory ([C][lk]), then the prefix
// sums of log w down the chunk, one thread per channel, in token order: the
// forward's order, so cum, ecum and L are the forward's bits.
template <typename T, typename W>
__device__ void load_chunk(const T* __restrict__ r, const T* __restrict__ k,
                           const W* __restrict__ w, long long rk_off,
                           int c_len, int kk, float* Rs, float* Ks,
                           float* Cum, float* Ecum, float* Last) {
  const int lk = kk + 1;
  for (int e = threadIdx.x; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    Rs[t * lk + ch] = ld(r + rk_off + e);
    Ks[t * lk + ch] = ld(k + rk_off + e);
    Cum[t * lk + ch] = logf(ld(w + rk_off + e));
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < kk; ch += kThreads) {
    float run = 0.0f;
    for (int t = 0; t < c_len; ++t) {
      const float lw = Cum[t * lk + ch];
      run += lw;
      Cum[t * lk + ch] = run;
      Ecum[t * lk + ch] = run - lw;
    }
    Last[ch] = run;
  }
  __syncthreads();
}

// columns [v0, v0 + VT) of the chunk's v and do into [C][LV] tiles, zero
// past V
template <typename T>
__device__ void load_tile(const T* __restrict__ v,
                          const float* __restrict__ dout, long long v_off,
                          int c_len, int vv, int v0, float* Vs, float* Ds) {
  for (int e = threadIdx.x; e < c_len * VT; e += kThreads) {
    const int t = e / VT;
    const int j = e % VT;
    const bool in = v0 + j < vv;
    const long long g = v_off + static_cast<long long>(t) * vv + v0 + j;
    Vs[t * LV + j] = in ? ld(v + g) : 0.0f;
    Ds[t * LV + j] = in ? dout[g] : 0.0f;
  }
}

// pair index p -> (t, s) with s < t (strict) or s <= t (diagonal): rows of
// t or t + 1 pairs start at t (t - 1) / 2 or t (t + 1) / 2
__device__ __forceinline__ void pair_below(int p, int& t, int& s) {
  t = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * p)) * 0.5f);
  while (t * (t - 1) / 2 > p) --t;
  while ((t + 1) * t / 2 <= p) ++t;
  s = p - t * (t - 1) / 2;
}
__device__ __forceinline__ void pair_on_or_below(int p, int& t, int& s) {
  t = static_cast<int>((sqrtf(1.0f + 8.0f * p) - 1.0f) * 0.5f);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  s = p - t * (t + 1) / 2;
}

// shared memory of bwd_local: r, k, cum, ecum as [C][K + 1]; A^T above the
// diagonal with dA below it, [C][C + 1]; the v and do tiles; db (C); L (K)
__host__ __device__ constexpr int local_smem_floats(int c, int kk) {
  return 4 * c * (kk + 1) + c * (c + 1) + 2 * c * LV + c + kk;
}
// shared memory of bwd_inter: r, k, cum, ecum; db (C); L (K); the v, do, S
// and G tiles, which afterwards hold r (do S^T) and k (v G^T) as [C][K + 1]
__host__ __device__ constexpr int inter_smem_floats(int c, int kk) {
  return 4 * c * (kk + 1) + c + kk +
         (2 * (c + kk) * LV > 2 * c * (kk + 1) ? 2 * (c + kk) * LV
                                               : 2 * c * (kk + 1));
}

// KT: K as a compile-time constant (16, hymba's SSM state, or 64), or 0 for
// any other K <= 64, read from kk_rt.
template <typename T, typename W, int KT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const W* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ dout,
                 float* __restrict__ decay, float* __restrict__ su,
                 float* __restrict__ sq, float* __restrict__ dr_p,
                 float* __restrict__ dk_p, float* __restrict__ dw_p,
                 float* __restrict__ dv_p, float* __restrict__ db_p,
                 float* __restrict__ du_p, int h, int t_len, int kk_rt,
                 int vv, int c_len) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KT ? KT : kk_rt;
  const int lk = kk + 1;
  const int la = c_len + 1;
  float* Rs = smem;                   // [C][lk] r, then r e^{ecum}
  float* Ks = Rs + c_len * lk;        // [C][lk] k, then k e^{L - cum}
  float* Cum = Ks + c_len * lk;       // [C][lk]
  float* Ecum = Cum + c_len * lk;     // [C][lk]
  float* AA = Ecum + c_len * lk;      // [C][la] A^T[s][t] (t >= s), dA[t][s] (t > s)
  float* Vs = AA + c_len * la;        // [C][LV]
  float* Ds = Vs + c_len * LV;        // [C][LV]
  float* Db = Ds + c_len * LV;        // [C]
  float* Last = Db + c_len;           // [K]

  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const long long bh = static_cast<long long>(blockIdx.z) * h + hi;
  const long long c0 = static_cast<long long>(ci) * c_len;
  const long long rk_off = (bh * t_len + c0) * kk;
  const long long v_off = (bh * t_len + c0) * vv;

  load_chunk(r, k, w, rk_off, c_len, kk, Rs, Ks, Cum, Ecum, Last);
  for (int ch = tid; ch < kk; ch += kThreads)
    decay[(bh * nc + ci) * kk + ch] = expf(Last[ch]);

  // A^T above the diagonal, one exponential per (t, s, k); dA below it and
  // db zeroed; the bonus on the diagonal
  for (int p = tid; p < c_len * (c_len - 1) / 2; p += kThreads) {
    int t, s;
    pair_below(p, t, s);
    const float* rt = Rs + t * lk;
    const float* et = Ecum + t * lk;
    const float* ks = Ks + s * lk;
    const float* cs = Cum + s * lk;
    float a = 0.0f;
    for (int ch = 0; ch < kk; ++ch)
      a = fmaf(rt[ch] * ks[ch], expf(et[ch] - cs[ch]), a);
    AA[s * la + t] = a;
    AA[t * la + s] = 0.0f;
  }
  for (int t = tid; t < c_len; t += kThreads) {
    float b = 0.0f;
    for (int ch = 0; ch < kk; ++ch)
      b = fmaf(Rs[t * lk + ch] * u[hi * kk + ch], Ks[t * lk + ch], b);
    AA[t * la + t] = b;
    Db[t] = 0.0f;
  }
  __syncthreads();

  // over tiles of V: dA_ts (s < t) and db_t += do_t . v_s, each pair's sum
  // kept by one thread; dv's intra and bonus part, A^T do, to scratch
  for (int v0 = 0; v0 < vv; v0 += VT) {
    load_tile(v, dout, v_off, c_len, vv, v0, Vs, Ds);
    __syncthreads();
    for (int p = tid; p < c_len * (c_len + 1) / 2; p += kThreads) {
      int t, s;
      pair_on_or_below(p, t, s);
      const float* dt = Ds + t * LV;
      const float* vs = Vs + s * LV;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < VT; ++j) acc = fmaf(dt[j], vs[j], acc);
      if (s < t)
        AA[t * la + s] += acc;
      else
        Db[t] += acc;
    }
    for (int e = tid; e < c_len * VT; e += kThreads) {
      const int s = e / VT;
      const int j = e % VT;
      if (v0 + j >= vv) continue;
      float acc = 0.0f;
      for (int t = s; t < c_len; ++t)
        acc = fmaf(AA[s * la + t], Ds[t * LV + j], acc);
      dv_p[v_off + static_cast<long long>(s) * vv + v0 + j] = acc;
    }
    __syncthreads();
  }

  // dr and dk inside the chunk (no bonus), one exponential per (t, s, k); the
  // thread of entry (t, k) sums t pairs for dr and C - 1 - t for dk
  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    const float et = Ecum[t * lk + ch];
    const float ct = Cum[t * lk + ch];
    float gr = 0.0f, gk = 0.0f;
    for (int s = 0; s < t; ++s)
      gr = fmaf(AA[t * la + s] * Ks[s * lk + ch],
                expf(et - Cum[s * lk + ch]), gr);
    for (int q = t + 1; q < c_len; ++q)
      gk = fmaf(AA[q * la + t] * Rs[q * lk + ch],
                expf(Ecum[q * lk + ch] - ct), gk);
    dr_p[rk_off + e] = gr;
    dk_p[rk_off + e] = gk;
  }
  // db to scratch; the chunk's share of du, sum_t r_t k_t db_t
  for (int t = tid; t < c_len; t += kThreads) db_p[bh * t_len + c0 + t] = Db[t];
  for (int ch = tid; ch < kk; ch += kThreads) {
    float g = 0.0f;
    for (int t = 0; t < c_len; ++t)
      g = fmaf(Rs[t * lk + ch] * Ks[t * lk + ch], Db[t], g);
    du_p[(bh * nc + ci) * kk + ch] = g;
  }
  // dw's intra part (header): a warp per channel, lane l holding M_j at
  // t = l and l + 32; j runs in order
  const int lane = tid & 31;
  for (int ch = tid >> 5; ch < kk; ch += kWarps) {
    const int t0 = lane;
    const int t1 = lane + 32;
    const bool in0 = t0 < c_len;
    const bool in1 = t1 < c_len;
    float m0 = 0.0f, m1 = 0.0f;
    for (int j = 0; j < c_len; ++j) {
      const float cj = Cum[j * lk + ch];
      float part = 0.0f;
      if (in0 && t0 > j)
        part = Rs[t0 * lk + ch] * expf(Ecum[t0 * lk + ch] - cj) * m0;
      if (in1 && t1 > j)
        part = fmaf(Rs[t1 * lk + ch] * expf(Ecum[t1 * lk + ch] - cj), m1,
                    part);
      part = warp_sum(part);
      if (lane == 0) dw_p[rk_off + static_cast<long long>(j) * kk + ch] = part;
      if (j + 1 < c_len) {
        const float wj = ld(w + rk_off + static_cast<long long>(j) * kk + ch);
        const float kj =
            Ks[j * lk + ch] * expf(Ecum[(j + 1) * lk + ch] - cj);
        if (in0 && t0 > j) m0 = fmaf(wj, m0, AA[t0 * la + j] * kj);
        if (in1 && t1 > j) m1 = fmaf(wj, m1, AA[t1 * la + j] * kj);
      }
    }
  }
  __syncthreads();

  // In place: r e^{ecum} and k e^{L - cum}, as the forward forms them.
  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    Rs[t * lk + ch] *= expf(Ecum[t * lk + ch]);
    Ks[t * lk + ch] *= expf(Last[ch] - Cum[t * lk + ch]);
  }
  __syncthreads();

  // Q_c = (r e^{ecum})^T do and U_c = (k e^{L - cum})^T v, summed over t in
  // order (U_c is the forward's contribution, bit for bit); a single tile of
  // V is still in place
  float* Q = sq + (bh * nc + ci) * kk * vv;
  float* U = su + (bh * nc + ci) * kk * vv;
  for (int v0 = 0; v0 < vv; v0 += VT) {
    if (vv > VT) {
      load_tile(v, dout, v_off, c_len, vv, v0, Vs, Ds);
      __syncthreads();
    }
    for (int e = tid; e < kk * VT; e += kThreads) {
      const int ch = e / VT;
      const int j = e % VT;
      if (v0 + j >= vv) continue;
      float q = 0.0f, uc = 0.0f;
      for (int t = 0; t < c_len; ++t) {
        q = fmaf(Rs[t * lk + ch], Ds[t * LV + j], q);
        uc = fmaf(Ks[t * lk + ch], Vs[t * LV + j], uc);
      }
      Q[ch * vv + v0 + j] = q;
      U[ch * vv + v0 + j] = uc;
    }
    if (vv > VT) __syncthreads();
  }
}

// One thread per (b, h, state element e = ch * V + col): the forward's scan,
// U_c replaced by the state entering chunk c; then the reverse scan from
// dstate (or 0), Q_c replaced by G_c, the gradient of the state leaving c.
__global__ void __launch_bounds__(kThreads)
bwd_scan_kernel(const float* __restrict__ decay, float* __restrict__ su,
                float* __restrict__ sq, const float* __restrict__ dstate,
                int kk, int vv, int nc) {
  const int kv = kk * vv;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= kv) return;
  const long long bh =
      static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int ch = e / vv;
  float* U = su + bh * nc * kv + e;
  float* Q = sq + bh * nc * kv + e;
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
  float g = dstate ? dstate[bh * kv + e] : 0.0f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kScanBatch) {
    float qc[kScanBatch], dc[kScanBatch];
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      const bool in = c1 - i >= 0;
      qc[i] = in ? Q[static_cast<long long>(c1 - i) * kv] : 0.0f;
      dc[i] = in ? D[static_cast<long long>(c1 - i) * kk] : 1.0f;
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c1 - i < 0) break;
      Q[static_cast<long long>(c1 - i) * kv] = g;
      g = fmaf(dc[i], g, qc[i]);
    }
  }
}

template <typename T, typename W, int KT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_inter_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const W* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ dout,
                 const float* __restrict__ s_in, const float* __restrict__ gs,
                 const float* __restrict__ dr_p,
                 const float* __restrict__ dk_p,
                 const float* __restrict__ dw_p,
                 const float* __restrict__ dv_p,
                 const float* __restrict__ db_p, T* __restrict__ dr,
                 T* __restrict__ dk, T* __restrict__ dv, W* __restrict__ dw,
                 int h, int t_len, int kk_rt, int vv, int c_len) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KT ? KT : kk_rt;
  const int lk = kk + 1;
  float* Rs = smem;                   // [C][lk] r
  float* Ks = Rs + c_len * lk;        // [C][lk] k, k e^{L - cum} over the tiles
  float* Cum = Ks + c_len * lk;       // [C][lk]
  float* Ecum = Cum + c_len * lk;     // [C][lk]
  float* Db = Ecum + c_len * lk;      // [C]
  float* Last = Db + c_len;           // [K]
  float* Vs = Last + kk;              // [C][LV]
  float* Ds = Vs + c_len * LV;        // [C][LV]
  float* Ss = Ds + c_len * LV;        // [K][LV] S_{c-1}
  float* Gs = Ss + kk * LV;           // [K][LV] G_c
  float* Io = Vs;                     // after the tiles: [C][lk] r (do S^T)
  float* Sg = Io + c_len * lk;        //                  [C][lk] k (v G^T)

  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const long long bh = static_cast<long long>(blockIdx.z) * h + hi;
  const long long c0 = static_cast<long long>(ci) * c_len;
  const long long rk_off = (bh * t_len + c0) * kk;
  const long long v_off = (bh * t_len + c0) * vv;
  const float* S = s_in + (bh * nc + ci) * kk * vv;
  const float* G = gs + (bh * nc + ci) * kk * vv;

  load_chunk(r, k, w, rk_off, c_len, kk, Rs, Ks, Cum, Ecum, Last);
  for (int t = tid; t < c_len; t += kThreads) Db[t] = db_p[bh * t_len + c0 + t];
  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    Ks[t * lk + ch] *= expf(Last[ch] - Cum[t * lk + ch]);
  }

  // per owned entry (t, k): io = do_t S^T, sg = v_t G^T; pi = sum_v S G
  float io[kEntries], sg[kEntries];
#pragma unroll
  for (int i = 0; i < kEntries; ++i) io[i] = sg[i] = 0.0f;
  float pi = 0.0f;
  for (int v0 = 0; v0 < vv; v0 += VT) {
    __syncthreads();  // Ks is scaled; the last tile's readers are done
    load_tile(v, dout, v_off, c_len, vv, v0, Vs, Ds);
    for (int e = tid; e < kk * VT; e += kThreads) {
      const int ch = e / VT;
      const int j = e % VT;
      const bool in = v0 + j < vv;
      Ss[ch * LV + j] = in ? S[ch * vv + v0 + j] : 0.0f;
      Gs[ch * LV + j] = in ? G[ch * vv + v0 + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      const int e = tid + i * kThreads;
      if (e < c_len * kk) {
        const float* dt = Ds + (e / kk) * LV;
        const float* vt = Vs + (e / kk) * LV;
        const float* sc = Ss + (e % kk) * LV;
        const float* gc = Gs + (e % kk) * LV;
        float a = io[i], b = sg[i];
#pragma unroll 8
        for (int j = 0; j < VT; ++j) {
          a = fmaf(dt[j], sc[j], a);
          b = fmaf(vt[j], gc[j], b);
        }
        io[i] = a;
        sg[i] = b;
      }
    }
    // dv = its intra and bonus part + (k e^{L - cum}) G_c
    for (int e = tid; e < c_len * VT; e += kThreads) {
      const int s = e / VT;
      const int j = e % VT;
      if (v0 + j >= vv) continue;
      float acc = 0.0f;
      for (int ch = 0; ch < kk; ++ch)
        acc = fmaf(Ks[s * lk + ch], Gs[ch * LV + j], acc);
      const long long g = v_off + static_cast<long long>(s) * vv + v0 + j;
      st(dv + g, dv_p[g] + acc);
    }
    if (tid < kk)
      for (int j = 0; j < VT; ++j)
        pi = fmaf(Ss[tid * LV + j], Gs[tid * LV + j], pi);
  }
  __syncthreads();  // the tiles are done: Io and Sg take their place

  for (int e = tid; e < c_len * kk; e += kThreads)
    Ks[(e / kk) * lk + e % kk] = ld(k + rk_off + e);
  __syncthreads();
  // dr and dk with every part; r io and k sg for dw
#pragma unroll
  for (int i = 0; i < kEntries; ++i) {
    const int e = tid + i * kThreads;
    if (e < c_len * kk) {
      const int t = e / kk;
      const int ch = e % kk;
      const float rt = Rs[t * lk + ch];
      const float kt = Ks[t * lk + ch];
      const float bonus = u[hi * kk + ch] * Db[t];
      const float gr = dr_p[rk_off + e] + expf(Ecum[t * lk + ch]) * io[i];
      const float gk =
          dk_p[rk_off + e] + expf(Last[ch] - Cum[t * lk + ch]) * sg[i];
      st(dr + rk_off + e, fmaf(bonus, kt, gr));
      st(dk + rk_off + e, fmaf(bonus, rt, gk));
      Io[t * lk + ch] = rt * io[i];
      Sg[t * lk + ch] = kt * sg[i];
    }
  }
  __syncthreads();

  // dw = its intra part + e^{ecum_j} Y_j + e^{L - cum_j} Z_j (header), one
  // thread per channel: Y backwards in place of r io, then Z forwards
  if (tid < kk) {
    const int ch = tid;
    float y = 0.0f;
    for (int j = c_len - 1; j >= 0; --j) {
      const float x = Io[j * lk + ch];
      Io[j * lk + ch] = y;
      if (j > 0)
        y = fmaf(ld(w + rk_off + static_cast<long long>(j) * kk + ch), y,
                 expf(Ecum[j * lk + ch] - Cum[(j - 1) * lk + ch]) * x);
    }
    float z = pi;
    for (int j = 0; j < c_len; ++j) {
      const long long g = rk_off + static_cast<long long>(j) * kk + ch;
      const float cj = Cum[j * lk + ch];
      st(dw + g, dw_p[g] + expf(Ecum[j * lk + ch]) * Io[j * lk + ch] +
                     expf(Last[ch] - cj) * z);
      if (j + 1 < c_len)
        z = fmaf(ld(w + g), z,
                 expf(Ecum[(j + 1) * lk + ch] - cj) * Sg[j * lk + ch]);
    }
  }
}

// du[h][k] = the chunks' shares summed over b, then over the chunks, in order.
__global__ void __launch_bounds__(kThreads)
bwd_du_kernel(const float* __restrict__ du_p, float* __restrict__ du, int b,
              int h, int kk, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= h * kk) return;
  const int hi = e / kk;
  const int ch = e % kk;
  float g = 0.0f;
  for (int bi = 0; bi < b; ++bi) {
    const float* p = du_p + static_cast<long long>(bi * h + hi) * nc * kk + ch;
    for (int c = 0; c < nc; ++c) g += p[static_cast<long long>(c) * kk];
  }
  du[e] = g;
}

template <typename T, typename W, int KT>
int launch_k(const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* dout, const float* dstate, void* dr,
             void* dk, void* dv, void* dw, float* du, float* scratch, int b,
             int h, int t_len, int kk, int vv, int c_len, cudaStream_t stream,
             int device) {
  const int nc = t_len / c_len;
  const long long bh = static_cast<long long>(b) * h;
  float* decay = scratch;
  float* su = decay + bh * nc * kk;
  float* sq = su + bh * nc * kk * vv;
  float* dr_p = sq + bh * nc * kk * vv;
  float* dk_p = dr_p + bh * t_len * kk;
  float* dw_p = dk_p + bh * t_len * kk;
  float* dv_p = dw_p + bh * t_len * kk;
  float* db_p = dv_p + bh * t_len * vv;
  float* du_p = db_p + bh * t_len;

  const int local_bytes =
      local_smem_floats(c_len, kk) * static_cast<int>(sizeof(float));
  static std::atomic<int> local_set[64];  // zero: static storage
  cudaError_t err = allow_smem(local_set, bwd_local_kernel<T, W, KT>,
                               local_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_local_kernel<T, W, KT><<<dim3(nc, h, b), kThreads, local_bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const W*>(w), u, dout, decay, su,
      sq, dr_p, dk_p, dw_p, dv_p, db_p, du_p, h, t_len, kk, vv, c_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd_scan_kernel<<<dim3((kk * vv + kThreads - 1) / kThreads, h, b), kThreads,
                    0, stream>>>(decay, su, sq, dstate, kk, vv, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int inter_bytes =
      inter_smem_floats(c_len, kk) * static_cast<int>(sizeof(float));
  static std::atomic<int> inter_set[64];
  err = allow_smem(inter_set, bwd_inter_kernel<T, W, KT>, inter_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_inter_kernel<T, W, KT><<<dim3(nc, h, b), kThreads, inter_bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const W*>(w), u, dout, su, sq,
      dr_p, dk_p, dw_p, dv_p, db_p, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<W*>(dw), h, t_len, kk, vv, c_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd_du_kernel<<<dim3((h * kk + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(du_p, du, b, h, kk, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* dout, const float* dstate, void* dr,
           void* dk, void* dv, void* dw, float* du, float* scratch, int b,
           int h, int t_len, int kk, int vv, int c_len, cudaStream_t s,
           int device) {
  switch (kk) {
    case 16: return launch_k<T, W, 16>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
    case 64: return launch_k<T, W, 64>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
    default: return launch_k<T, W, 0>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  }
}

template <typename T>
int launch_w(int w_dtype, const void* r, const void* k, const void* v,
             const void* w, const float* u, const float* dout,
             const float* dstate, void* dr, void* dk, void* dv, void* dw,
             float* du, float* scratch, int b, int h, int t_len, int kk,
             int vv, int c_len, cudaStream_t s, int device) {
  if (w_dtype == 0)
    return launch<T, float>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  if (w_dtype == 1)
    return launch<T, __nv_bfloat16>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Runs K6's backward (four launches) on `stream`.  r, k, w are (b, h, t_len,
// kk), v (b, h, t_len, vv), u (h, kk) float32, dout (b, h, t_len, vv)
// float32, dstate (b, h, kk, vv) float32 or null (no cotangent of the final
// state); dr, dk (r's type), dv (v's), dw (w's) of their inputs' shapes and
// du (h, kk) float32 are written; all contiguous.  scratch holds
// b*h*(nc*kk*(1 + 2*vv) + t_len*(3*kk + vv + 1) + nc*kk) float32 (nc =
// t_len / c_len).  dtype is the type of r, k and v, w_dtype that of w: 0 =
// float32, 1 = bfloat16.  The caller checks t_len % c_len == 0, c_len <= 64
// and kk <= 64.
int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* dout, const float* dstate,
                   void* dr, void* dk, void* dv, void* dw, float* du,
                   float* scratch, int b, int h, int t_len, int kk, int vv,
                   int c_len, int dtype, int w_dtype, void* stream,
                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_w<float>(w_dtype, r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(w_dtype, r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
