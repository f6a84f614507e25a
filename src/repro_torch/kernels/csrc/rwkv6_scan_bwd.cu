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
// holds j carries w_j itself, so both routes below sum dw_j with it left
// out, every exponent <= 0.
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
// by bytes at both training shapes.
//
// Two routes, picked by the caller from the shape before launch
// (kernels/rwkv6_scan.py, bwd_route): "mma" for bfloat16 r, k, v with K a
// multiple of 8 and C a multiple of 16 (every training path: the models pass
// bfloat16 r, k, v, float32 w), "fma" for float32 r, k, v and other shapes.
// Neither falls back to the other: a failed launch returns its error.
//
// The "mma" route (rwkv6_scan_bwd_mma): TF32 tensor cores, sub-chunks.
//   Work in log2 units: cx[x] = sum_{i<x} log2 w_i over the chunk, so
//   cx[t] = ecum_t, cx[t+1] = cum_t, cx[0] = 0, and every factor below is
//   2^{a difference of cx}; the sums are taken in token order, so cx falls
//   monotonically and every such difference written "later minus earlier"
//   is <= 0 in float32 too.  A chunk is cut into sub-chunks of 16 tokens;
//   sub-chunk J has first token J0, last eJ, cq = cx[J0], ce = cx[eJ + 1].
//   * Across sub-chunks every pair factor splits at a boundary into two
//     factors whose exponents are both <= 0: for t in T after s's
//     sub-chunk, 2^{ecum_t - cum_s} = 2^{cx[t] - cx[T0]} 2^{cx[T0] - cx[s+1]},
//     so A[T, < T0] = Rf Kf^(T)T with Rf = r 2^{cx[t] - cx[T0]} and Kf^(T) =
//     k 2^{cx[T0] - cx[s+1]}: products on the tensor cores.  Nothing
//     overflows at any decay; a factor underflows only where the exact term
//     is already below float32's range.  Pairs inside a sub-chunk take one
//     exponential per (t, s, k): a quarter of the first design's at C = 64.
//     Pairs s >= t are never visited (no -inf arithmetic).
//   * dr and dk the same way: P^(J) = dA[>= J0, < J0] Kf^(J) (dr's part from
//     earlier sub-chunks on J's rows), B^(J) = dA[> eJ, J]^T Rg^(J) with
//     Rg^(J) = r 2^{cx[t] - ce} (dk's part from later sub-chunks).  The
//     inter-chunk parts fold in as a token before the chunk (the entering
//     state) and one after it (the leaving gradient): F' = P^(J) + 2^{cq}
//     do S_{c-1}^T and B' = B^(J) + 2^{L - ce} v G_c^T on J's rows, so dr_t
//     = 2^{cx[t] - cq} F'_t + (inside J) + u k_t db_t and dk_s =
//     2^{ce - cx[s+1]} B'_s + (inside J) + u r_s db_s.
//   * dw_j (j in J), w_j left out of each pair r_t 2^{cx[t] - cx[j+1]} .
//     k_s 2^{cx[j] - cx[s+1]} . dA_ts, in four cases by where t and s lie:
//      (i)   t after J, s before J (the entering state and the leaving
//            gradient included): 2^{(ce - cx[j+1]) + (cx[j] - cq)} X'_J,
//            X'_J = sum_{t>eJ} Rg_t (P^(J)_t + 2^{cq} doS_t)
//                   + 2^{L - ce} (sum_{s<J0} Kf_s vG_s + 2^{cq} sum_v S G);
//      (ii)  t after J, s in J before j: 2^{ce - cx[j+1]} N_j, N_j = sum_s
//            k_s 2^{cx[j] - cx[s+1]} B'_s, a 16-wide triangular sum;
//      (iii) t in J after j, s before J: 2^{cx[j] - cq} sum_t rt_t F'_t,
//            rt_t = r_t 2^{cx[t] - cx[j+1]}, its mirror image;
//      (iv)  t and s in J: sum_t rt_t M_j[t], M_j[t] = sum_s dA_ts k_s
//            2^{cx[j] - cx[s+1]}, confined to 16 tokens.
//     One thread per (J, k) walks j through J in order, carrying M (16
//     values) and N, with M_{j+1} = 2^{cx[j+1] - cx[j]} M_j + dA_{.j} k_j
//     and N likewise; dr's and dk's parts inside J are M_j[j] and sum_t
//     dA_tj rt_t from the same factors.  Every exponent it evaluates is a
//     sum of terms <= 0 (tests/test_torch_rwkv6_bwd.py states the route in
//     plain torch, _subchunk_backward, and pins that).  The first design's
//     serial recurrences over the whole chunk for the inter-chunk parts of
//     dw (e^{ecum} Y, e^{L - cum} Z, still O(C K) a chunk) become case (i)
//     and the F' and B' rows, with no walk longer than 16 tokens.
//   Passes, four launches on one stream:
//    a. bwd_mma_prep, one block per (chunk, h, b): cx, d_c = 2^{L}, Q_c =
//       (r 2^{cx[t]})^T do and U_c = (k 2^{L - cx[t+1]})^T v on the tensor
//       cores (K x C x 64 tiles, the K rows padded to 16);
//    b. bwd_scan, as the fma route's: the states entering the chunks and the
//       gradients G_c leaving them;
//    c. bwd_mma_chunk, one block per (chunk, h, b), everything else of the
//       chunk: A (across sub-chunks on the tensor cores, inside them one
//       exponential per (t, s, k), one pair a thread, the bonus on A^T's
//       diagonal), then over tiles of 64 columns of V: dA = do v^T on the
//       sub-chunk blocks on or below the diagonal (db on its diagonal),
//       do S_{c-1}^T, v G_c^T and dv = (A^T + diag bonus) do + (k 2^{L -
//       cum}) G_c, dv stored at once; then P^(J) and B^(J), X'_J, F' and B',
//       and the walk, which writes dr, dk, dw and the chunk's share of du;
//    d. bwd_du, as the fma route's.
//   Every product is mma.sync m16n8k8 in TF32 with float32 accumulators,
//   each operand staged in float32 in shared memory (or formed in registers
//   from r, k and cx where it carries a factor) and rounded to TF32 to
//   nearest; a warp owns up to four (16 x 8) tiles of a product and issues
//   a step's fragment loads for all of them before its mma instructions
//   (mma_tiles).  Not bfloat16: do is float32 and the decay factors carry
//   float32 exponentials; rounding both to bfloat16 would spend most of the
//   5e-3 budget before the outputs are rounded to bfloat16 once.  Not
//   wgmma: the products are 16-row sub-chunk blocks, most of them
//   triangular, whose operands are formed in registers; a 64-row warpgroup
//   tile fits only do S^T, v G^T and dv.  Loads: r, k, w and v's first tile
//   16 bytes a thread and all issued before any is stored (one trip to
//   memory); do, S_{c-1} and G_c by cp.async (where V % 4 == 0), issued
//   first, landing while the prefix sums and A are formed.  A second buffer
//   for the next V tile would cost 48 KB and the second block an SM; every
//   model's V is one tile (64).  The walk is unrolled with J's cx, r and F'
//   in registers: a rolled walk executes every step's predicated-off pairs
//   and selects its per-token values, about three times the instructions.
//   Exponentials and log2 w on the SFU (ex2.approx and lg2.approx, about
//   2 ulp and 2^-22 absolute): w >= 1e-6 is normal, and an error of 2^-22
//   in a log2 w moves a factor by well under 1e-5.  Scratch: B H (NC K (1 +
//   2 V) + NC K) floats (d_c; U_c, then the entering state; Q_c, then G_c;
//   du's shares): the intra-chunk partials never leave the block.  Shared
//   memory at C = K = 64: 112 KB a chunk block (2 an SM), 88.5 KB a prep
//   block.  No atomics and every sum in a fixed order: two runs are
//   bit-identical.  U_c on the tensor cores is not the forward's bits, so
//   the recomputed states are not the forward's either; the tolerances hold
//   them (chip_smoke.py, phase 32).
//
// The "fma" route (rwkv6_scan_bwd): the first design, IEEE fp32 FMAs, expf
// and logf (no fast math), four launches on one stream, as the forward's
// three plus one:
//  1. bwd_local, one block per (chunk, h, b): the chunk's prefix sums of log w
//     in token order (the forward's order and bits); A^T with the bonus on its
//     diagonal, then over tiles of V: dA and db (stored below A^T's diagonal),
//     dv's intra and bonus part A^T do; dr's and dk's intra parts, one
//     exponential per (t, s, k); dw's intra part, a warp per channel with the
//     lanes over t, by the recurrence M_{j+1}[t] = w_j M_j[t] + e^{ecum_{j+1}
//     - cum_j} dA_tj k_j; db and the chunk's share of du; then Q_c and U_c,
//     the forward's contribution to the state, in the forward's summation
//     order (the states are the forward's, bit for bit).
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
//     dw's other two parts, e^{ecum_j} Y_j (Y_{j-1} = w_j Y_j + e^{ecum_j -
//     cum_{j-1}} r_j (do_j S_{c-1}^T)) and e^{L - cum_j} Z_j (Z_0 = sum_v
//     S_{c-1} G_c, Z_{j+1} = w_j Z_j + e^{ecum_{j+1} - cum_j} k_j (v_j
//     G_c^T)), one thread per channel.
//  4. bwd_du, one thread per (h, k): du summed over b, then over chunks.
// No atomics: each output and partial sum has one writer and a fixed order,
// so two runs are bit-identical.  Scratch (the caller's, float32):
//   B H (NC K (1 + 2 V) + T (3 K + V + 1) + NC K) floats.
// r, k, v may be float32 or bfloat16 (one type), w float32 or bfloat16, u, do
// and dstate float32; dr, dk, dv come in r's type, dw in w's, du float32.
// C <= 64 and K <= 64; V is any width (tiles of 32 columns, the last masked).
//
// C entry points: plain C interface for ctypes; each returns the first CUDA
// error of an attribute call or a launch (0 on success).

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

// ---------------------------------------------------------------------------
// The "mma" route (header): bfloat16 r, k, v; TF32 mma.sync; sub-chunks
// ---------------------------------------------------------------------------

constexpr int SB = 16;          // tokens of a sub-chunk
constexpr int MVT = 64;         // V columns per tile
constexpr int LDT = MVT + 4;    // row stride of bwd_mma_chunk's tiles
constexpr int LDQ = MVT + 8;    // row stride of bwd_mma_prep's tiles
constexpr int kMaxTiles = 4;    // (16 x 8) tiles of one product a warp owns

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[i] += tile i of the product a b: rows m0[i] + [0, 16), columns
// n0[i] + [0, 8), summed over k in [k0, k1) in steps of 8.  a(row, k) and
// b(k, col) give the operands' elements in float32, rounded here to TF32 to
// nearest.  kShareA (kShareB): every tile has tile 0's rows (columns), and
// their fragment is loaded once a step.  Every tile is computed (a caller
// points the tiles it has no use for at a valid one and ignores them), so
// a step's loads are all issued before its products and no branch depends
// on the data.  The sum over k runs in order: the same inputs give the
// same bits.
template <int N, bool kShareA, bool kShareB, class FA, class FB>
__device__ __forceinline__ void mma_tiles(float (&acc)[N][4],
                                          const int (&m0)[N],
                                          const int (&n0)[N], int k0, int k1,
                                          FA a, FB b) {
  constexpr int NA = kShareA ? 1 : N;
  constexpr int NB = kShareB ? 1 : N;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll 2
  for (int kb = k0; kb < k1; kb += 8) {
    uint32_t af[NA][4], bf[NB][2];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      af[i][0] = round_tf32(a(m0[i] + g, kb + q));
      af[i][1] = round_tf32(a(m0[i] + g + 8, kb + q));
      af[i][2] = round_tf32(a(m0[i] + g, kb + q + 4));
      af[i][3] = round_tf32(a(m0[i] + g + 8, kb + q + 4));
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      bf[i][0] = round_tf32(b(kb + q, n0[i] + g));
      bf[i][1] = round_tf32(b(kb + q + 4, n0[i] + g));
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      mma_tf32(acc[i], af[kShareA ? 0 : i], bf[kShareB ? 0 : i]);
  }
}

// Row and column of element e (0..3) of a thread's accumulator of a tile at
// (m0, n0): rows g and g + 8, columns 2q and 2q + 1.
__device__ __forceinline__ int frag_row(int m0, int e) {
  return m0 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int n0, int e) {
  return n0 + 2 * (threadIdx.x & 3) + (e & 1);
}

// Columns [v0, v0 + MVT) of the n0 rows of src0, then the n1 rows of src1
// and the n1 rows of src2 (row stride vv floats each), into consecutive
// rows of dst (row stride ld), zero past vv: cp.async, 16 bytes a copy,
// where vv % 4 == 0 (the caller commits the group), else one float a
// thread.
__device__ __noinline__ void stage_rows(float* dst, int ld, const float* src0,
                                        int n0, const float* src1,
                                        const float* src2, int n1, int v0,
                                        int vv) {
  const int n = n0 + 2 * n1;
  const bool vec = (vv & 3) == 0;
  const int per = vec ? MVT / 4 : MVT;
#pragma unroll 1
  for (int e = threadIdx.x; e < n * per; e += kThreads) {
    const int row = e / per;
    const float* src = row < n0 ? src0 + static_cast<long long>(row) * vv
                       : row < n0 + n1
                           ? src1 + static_cast<long long>(row - n0) * vv
                           : src2 + static_cast<long long>(row - n0 - n1) * vv;
    if (vec) {
      const int c4 = (e % per) * 4;
      const bool in = v0 + c4 < vv;
      cp_async16(dst + row * ld + c4, src + (in ? v0 + c4 : 0), in);
    } else {
      const int j = e % per;
      dst[row * ld + j] = v0 + j < vv ? src[v0 + j] : 0.0f;
    }
  }
}

// 8 consecutive elements (16 or 32 bytes, aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t wd[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(wd[i] << 16);
    x[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Rows 1..C of cx (log2 w, one row a token) summed down the chunk in token
// order, one thread per channel; 16 rows loaded ahead of their sums.
__device__ __noinline__ void prefix_rows(float* Cx, int lc, int kk,
                                         int c_len) {
  for (int ch = threadIdx.x; ch < kk; ch += kThreads) {
    float run = 0.0f;
    for (int x0 = 1; x0 <= c_len; x0 += SB) {
      float lw[SB];
#pragma unroll
      for (int i = 0; i < SB; ++i) lw[i] = Cx[(x0 + i) * lc + ch];
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        run += lw[i];
        Cx[(x0 + i) * lc + ch] = run;
      }
    }
  }
}

// The chunk's C x K elements of r, k (bfloat16) and w, and columns
// [0, MVT) of its C rows of v (bfloat16, row stride vv; zero past vv), 8 a
// load (a chunk holds at most 512 groups of 8 of each, two a thread), every
// load of a thread issued before its stores: one trip to memory.
// put(t, ch, r8, k8, w8) and put_v(t, j, x) store them; where vv % 8 != 0 v
// is loaded one element a thread after the rest.
template <typename W, class Put, class PutV>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* r,
                                           const __nv_bfloat16* k,
                                           const W* w,
                                           const __nv_bfloat16* v, int c_len,
                                           int kk, int vv, Put put,
                                           PutV put_v) {
  const int n = c_len * kk;
  const bool vvec = (vv & 7) == 0;
  float rx[2][8], kx[2][8], wx[2][8], vx[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = 8 * (threadIdx.x + kThreads * i);
    if (e < n) {
      load8(r + e, rx[i]);
      load8(k + e, kx[i]);
      load8(w + e, wx[i]);
    }
    const int ev = threadIdx.x + kThreads * i;   // v group: row ev / 8
    const int col = 8 * (ev % (MVT / 8));
    if (vvec && ev < c_len * (MVT / 8) && col < vv)
      load8(v + static_cast<long long>(ev / (MVT / 8)) * vv + col, vx[i]);
    else
#pragma unroll
      for (int j = 0; j < 8; ++j) vx[i][j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = 8 * (threadIdx.x + kThreads * i);
    if (e < n) put(e / kk, e % kk, rx[i], kx[i], wx[i]);
    const int ev = threadIdx.x + kThreads * i;
    if (vvec && ev < c_len * (MVT / 8))
#pragma unroll
      for (int j = 0; j < 8; ++j)
        put_v(ev / (MVT / 8), 8 * (ev % (MVT / 8)) + j, vx[i][j]);
  }
  if (!vvec)
#pragma unroll 1
    for (int e = threadIdx.x; e < c_len * MVT; e += kThreads) {
      const int t = e / MVT;
      const int j = e % MVT;
      put_v(t, j,
            j < vv ? ld(v + static_cast<long long>(t) * vv + j) : 0.0f);
    }
}

// Columns [v0, v0 + MVT) of the chunk's C rows of v (bfloat16, row stride
// vv), zero past vv, to put(t, j, x): 8 a load where vv % 8 == 0 (two
// groups a thread, both loaded before either is stored), else one a thread.
template <class Put>
__device__ __forceinline__ void stage_v(const __nv_bfloat16* v, int vv,
                                        int c_len, int v0, Put put) {
  if ((vv & 7) == 0) {
    float x[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + kThreads * i;   // group: row e / 8
      const int col = v0 + 8 * (e % (MVT / 8));
      if (e < c_len * (MVT / 8) && col < vv)
        load8(v + static_cast<long long>(e / (MVT / 8)) * vv + col, x[i]);
      else
#pragma unroll
        for (int j = 0; j < 8; ++j) x[i][j] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = threadIdx.x + kThreads * i;
      if (e < c_len * (MVT / 8))
#pragma unroll
        for (int j = 0; j < 8; ++j)
          put(e / (MVT / 8), 8 * (e % (MVT / 8)) + j, x[i][j]);
    }
  } else {
    for (int e = threadIdx.x; e < c_len * MVT; e += kThreads) {
      const int t = e / MVT;
      const int j = e % MVT;
      put(t, j, v0 + j < vv ? ld(v + static_cast<long long>(t) * vv + v0 + j)
                            : 0.0f);
    }
  }
}

// shared memory of bwd_mma_prep: cx [C + 1][K + 1]; r 2^{cx[t]} and
// k 2^{L - cx[t+1]} as [C][K + 8]; the do and v tiles [C][LDQ]
__host__ __device__ constexpr int prep_smem_floats(int c, int kk) {
  return up4((c + 1) * (kk + 1)) + 2 * c * (kk + 8) + 2 * c * LDQ;
}

// Pass a: cx, d_c = 2^{L}, Q_c = (r 2^{cx[t]})^T do and U_c =
// (k 2^{L - cx[t+1]})^T v, one block per (chunk, h, b).
template <typename W, int KT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_mma_prep_kernel(const __nv_bfloat16* __restrict__ r,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const W* __restrict__ w, const float* __restrict__ dout,
                    float* __restrict__ decay, float* __restrict__ su,
                    float* __restrict__ sq, int h, int t_len, int kk_rt,
                    int vv, int c_len) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KT ? KT : kk_rt;
  const int lc = kk + 1;
  const int lr = kk + 8;   // K = 16, 64: a fragment's column reads, 32 banks
  float* Cx = smem;                  // [C + 1][lc]
  float* Re = Cx + up4((c_len + 1) * lc);   // [C][lr]
  float* Kd = Re + c_len * lr;              // [C][lr]
  float* Ds = Kd + c_len * lr;              // [C][LDQ] do
  float* Vs = Ds + c_len * LDQ;             // [C][LDQ] v

  const int ci = blockIdx.x;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long bh = static_cast<long long>(blockIdx.z) * h + blockIdx.y;
  const long long c0 = static_cast<long long>(ci) * c_len;
  const long long rk_off = (bh * t_len + c0) * kk;
  const long long v_off = (bh * t_len + c0) * vv;

  auto put_v = [&](int t, int j, float x) { Vs[t * LDQ + j] = x; };
  auto stage = [&](int v0) {
    stage_rows(Ds, LDQ, dout + v_off, c_len, nullptr, nullptr, 0, v0, vv);
    cp_async_commit();
    if (v0) stage_v(v + v_off, vv, c_len, v0, put_v);
  };
  stage(0);
  // r and k raw into Re and Kd for now, log2 w into cx, v tile 0
  load_chunk(r + rk_off, k + rk_off, w + rk_off, v + v_off, c_len, kk, vv,
             [&](int t, int ch, const float (&r8)[8], const float (&k8)[8],
                 const float (&w8)[8]) {
#pragma unroll
               for (int i = 0; i < 8; ++i) {
                 Re[t * lr + ch + i] = r8[i];
                 Kd[t * lr + ch + i] = k8[i];
                 Cx[(t + 1) * lc + ch + i] = __log2f(w8[i]);
               }
             },
             put_v);
  for (int ch = tid; ch < kk; ch += kThreads) Cx[ch] = 0.0f;
  __syncthreads();
  prefix_rows(Cx, lc, kk, c_len);
  __syncthreads();
  for (int ch = tid; ch < kk; ch += kThreads)
    decay[(bh * nc + ci) * kk + ch] = fast_exp2(Cx[c_len * lc + ch]);
  for (int e = tid; e < c_len * kk; e += kThreads) {
    const int t = e / kk;
    const int ch = e % kk;
    Re[t * lr + ch] *= fast_exp2(Cx[t * lc + ch]);
    Kd[t * lr + ch] *=
        fast_exp2(Cx[c_len * lc + ch] - Cx[(t + 1) * lc + ch]);
  }

  // Q and U on each V tile: rows K (in tiles of 16, the last padded with
  // zeros), columns 64, summed over the C tokens; warp w owns column tile w
  float* Q = sq + (bh * nc + ci) * kk * vv;
  float* U = su + (bh * nc + ci) * kk * vv;
  constexpr int NQ = KT ? (KT + 15) / 16 : kMaxTiles;   // row tiles
  const int nt = (kk + 15) / 16;
  int m0[NQ], n0[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m0[i] = i < nt ? 16 * i : 0;
    n0[i] = 8 * warp;
  }
  for (int v0 = 0; v0 < vv; v0 += MVT) {
    if (v0) {
      __syncthreads();  // the last tile's readers are done
      stage(v0);
    }
    cp_async_wait<0>();
    __syncthreads();
    float aq[NQ][4] = {}, au[NQ][4] = {};
    mma_tiles<NQ, false, true>(
        aq, m0, n0, 0, c_len,
        [&](int ch, int t) { return ch < kk ? Re[t * lr + ch] : 0.0f; },
        [&](int t, int j) { return Ds[t * LDQ + j]; });
    mma_tiles<NQ, false, true>(
        au, m0, n0, 0, c_len,
        [&](int ch, int t) { return ch < kk ? Kd[t * lr + ch] : 0.0f; },
        [&](int t, int j) { return Vs[t * LDQ + j]; });
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = frag_row(m0[i], e);
        const int col = v0 + frag_col(n0[i], e);
        if (ch < kk && col < vv) {
          Q[ch * vv + col] = aq[i][e];
          U[ch * vv + col] = au[i][e];
        }
      }
    }
  }
}

// rows of P^(J) kept for X'_J: those after J, for 1 <= J <= NSB - 2; J's
// start at pb_base(c, J)
__host__ __device__ constexpr int pb_base(int c, int jb) {
  return jb >= 1 ? (jb - 1) * c - SB / 2 * jb * (jb + 1) + SB : 0;
}
__host__ __device__ constexpr int pb_rows(int c) {
  return c / SB >= 2 ? pb_base(c, c / SB - 1) : 0;
}
// shared memory of bwd_mma_chunk: cx [C + 1][K + 1]; r and k in bfloat16
// [C][K + 2]; u, sum_v S G, X' and du's shares; then either A^T [C][C + 4]
// and the tiles (do [C][LDT], S and G [K][LDT], v in bfloat16 [C][LDT]) or,
// after the tiles, dA [C][C + 4], do S^T (then F') and v G^T (then B') as
// [C][K + 4] and P^(J)'s rows after J [pb_rows][K + 4]
__host__ __device__ constexpr int chunk_fixed_floats(int c, int kk) {
  return up4((c + 1) * (kk + 1)) + 2 * up4(c * (kk + 2) / 2) + 2 * up4(kk) +
         2 * up4(c / SB * kk);
}
__host__ __device__ constexpr int chunk_smem_floats(int c, int kk) {
  return chunk_fixed_floats(c, kk) +
         (c * (c + 4) + c * LDT + 2 * kk * LDT + c * LDT / 2 >
                  c * (c + 4) + (2 * c + pb_rows(c)) * (kk + 4)
              ? c * (c + 4) + c * LDT + 2 * kk * LDT + c * LDT / 2
              : c * (c + 4) + (2 * c + pb_rows(c)) * (kk + 4));
}

// Pass c: everything of one chunk past the scans (header), one block per
// (chunk, h, b).
template <typename W, int KT>
__global__ void __launch_bounds__(kThreads, 2)
bwd_mma_chunk_kernel(const __nv_bfloat16* __restrict__ r,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const W* __restrict__ w, const float* __restrict__ u,
                     const float* __restrict__ dout,
                     const float* __restrict__ s_in,
                     const float* __restrict__ gs,
                     __nv_bfloat16* __restrict__ dr,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, W* __restrict__ dw,
                     float* __restrict__ du_p, int h, int t_len, int kk_rt,
                     int vv, int c_len) {
  extern __shared__ __align__(16) float smem[];
  const int kk = KT ? KT : kk_rt;
  const int nsb = c_len / SB;
  const int lc = kk + 1;   // odd: a row a lane reads distinct banks
  const int lb = kk + 2;   // bfloat16: an odd number of words
  const int la = c_len + 4;
  const int lk = kk + 4;
  float* Cx = smem;                                      // [C + 1][lc]
  __nv_bfloat16* Rb =
      reinterpret_cast<__nv_bfloat16*>(Cx + up4((c_len + 1) * lc));
  __nv_bfloat16* Kb = Rb + 2 * up4(c_len * lb / 2);      // [C][lb]
  float* Us = reinterpret_cast<float*>(Kb + 2 * up4(c_len * lb / 2));
  float* Pi = Us + up4(kk);                              // [K] sum_v S G
  float* Xp = Pi + up4(kk);                              // [NSB][K] X'
  float* Dup = Xp + up4(nsb * kk);                       // [NSB][K]
  float* work = Dup + up4(nsb * kk);
  float* At = work;                     // [C][la] A^T[s][t], bonus on t = s
  float* Ds = At + c_len * la;          // [C][LDT] do
  float* Ss = Ds + c_len * LDT;         // [K][LDT] S_{c-1}
  float* Gs = Ss + kk * LDT;            // [K][LDT] G_c
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(Gs + kk * LDT);
  float* dA = work;                     // after the tiles: [C][la] dA[t][s]
  float* Fp = dA + c_len * la;          // [C][lk] do S^T, then F'
  float* Bp = Fp + c_len * lk;          // [C][lk] v G^T, then B'
  float* Pb = Bp + c_len * lk;          // [pb_rows][lk]

  const int ci = blockIdx.x;
  const int hi = blockIdx.y;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long bh = static_cast<long long>(blockIdx.z) * h + hi;
  const long long c0 = static_cast<long long>(ci) * c_len;
  const long long rk_off = (bh * t_len + c0) * kk;
  const long long v_off = (bh * t_len + c0) * vv;
  const float* S = s_in + (bh * nc + ci) * kk * vv;
  const float* G = gs + (bh * nc + ci) * kk * vv;
  const int ntk = kk / 8;
  auto cx = [&](int x, int ch) { return Cx[x * lc + ch]; };
  auto rv = [&](int t, int ch) { return bf2f(Rb[t * lb + ch]); };
  auto kv = [&](int t, int ch) { return bf2f(Kb[t * lb + ch]); };

  // V tile 0 in flight while the chunk loads and A is formed (Ss and Gs
  // follow Ds)
  auto put_v = [&](int t, int j, float x) {
    Vb[t * LDT + j] = __float2bfloat16(x);   // exact: x is a bfloat16
  };
  auto stage = [&](int v0) {
    stage_rows(Ds, LDT, dout + v_off, c_len, S, G, kk, v0, vv);
    cp_async_commit();
    if (v0) stage_v(v + v_off, vv, c_len, v0, put_v);
  };
  stage(0);
  load_chunk(r + rk_off, k + rk_off, w + rk_off, v + v_off, c_len, kk, vv,
             [&](int t, int ch, const float (&r8)[8], const float (&k8)[8],
                 const float (&w8)[8]) {
#pragma unroll
               for (int i = 0; i < 8; ++i) {
                 Rb[t * lb + ch + i] = __float2bfloat16(r8[i]);
                 Kb[t * lb + ch + i] = __float2bfloat16(k8[i]);
                 Cx[(t + 1) * lc + ch + i] = __log2f(w8[i]);
               }
             },
             put_v);
  for (int ch = tid; ch < kk; ch += kThreads) {
    Cx[ch] = 0.0f;
    Us[ch] = u[hi * kk + ch];
  }
  __syncthreads();
  prefix_rows(Cx, lc, kk, c_len);
  __syncthreads();

  // A^T across sub-chunks: A[T, < T0] = Rf Kf^(T)T, one (16 x 8) tile of
  // (t in T, 8 s) a task, both factors formed in registers
  for (int task = warp; task < nsb * (nsb - 1); task += kWarps) {
    int jt = 1;
    while ((jt + 1) * jt <= task) ++jt;
    const int t0 = jt * SB;
    float acc[1][4] = {};
    const int m0[1] = {t0}, n0[1] = {(task - jt * (jt - 1)) * 8};
    mma_tiles<1, true, true>(
        acc, m0, n0, 0, kk,
        [&](int t, int ch) {
          return rv(t, ch) * fast_exp2(cx(t, ch) - cx(t0, ch));
        },
        [&](int ch, int s) {
          return kv(s, ch) * fast_exp2(cx(t0, ch) - cx(s + 1, ch));
        });
#pragma unroll
    for (int e = 0; e < 4; ++e)
      At[frag_col(n0[0], e) * la + frag_row(t0, e)] = acc[0][e];
  }
  // inside sub-chunks: one exponential per (t, s, k) for each pair s < t
  // (p = t' (t' - 1) / 2 + s' in sub-chunk coordinates), a zero at (t, s)
  // of A^T; the bonus for s = t
  constexpr int kPairs = SB * (SB - 1) / 2;
  for (int p = tid; p < nsb * kPairs; p += kThreads) {
    const int base = p / kPairs * SB;
    int tl, sl;
    pair_below(p % kPairs, tl, sl);
    const int t = base + tl;
    const int s = base + sl;
    float a[4] = {};
#pragma unroll 2
    for (int c4 = 0; c4 < kk; c4 += 4)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = fmaf(rv(t, c4 + i) * kv(s, c4 + i),
                    fast_exp2(cx(t, c4 + i) - cx(s + 1, c4 + i)), a[i]);
    At[s * la + t] = (a[0] + a[1]) + (a[2] + a[3]);
    At[t * la + s] = 0.0f;
  }
  for (int t = tid; t < c_len; t += kThreads) {
    float a = 0.0f;
#pragma unroll 4
    for (int ch = 0; ch < kk; ++ch)
      a = fmaf(rv(t, ch) * Us[ch], kv(t, ch), a);
    At[t * la + t] = a;
  }
  cp_async_wait<0>();
  __syncthreads();

  // Over tiles of V: dA (the (16 x 8) tiles of the sub-chunk blocks on and
  // below the diagonal), do S^T and v G^T summed in registers; dv of the
  // tile's columns stored at once.  Warp w owns dA tiles w, w + 8, w + 16
  // and the C x K tiles w + 8 i (i < NCK); dv's tiles of one row block, NSB
  // row blocks of 8 column tiles shared by kWarps / NSB warps each.  A tile
  // a warp does not own points at tile 0, and its result is not used.
  constexpr int NCK = KT ? (KT + 15) / 16 : kMaxTiles;
  const int n_da = nsb * (nsb + 1);
  const int n_ck = nsb * ntk;
  int da_m[3], da_n[3], n_da_w = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int tile = warp + kWarps * i;
    const int blk = (tile < n_da ? tile : 0) / 2;
    int jt = 0;
    while ((jt + 1) * (jt + 2) / 2 <= blk) ++jt;
    da_m[i] = jt * SB;
    da_n[i] = (blk - jt * (jt + 1) / 2) * SB + (tile % 2) * 8;
    n_da_w += tile < n_da;
  }
  int ck_m[NCK], ck_n[NCK], n_ck_w = 0;
#pragma unroll
  for (int i = 0; i < NCK; ++i) {
    const int tile = warp + kWarps * i < n_ck ? warp + kWarps * i : 0;
    ck_m[i] = tile / ntk * SB;
    ck_n[i] = tile % ntk * 8;
    n_ck_w += warp + kWarps * i < n_ck;
  }
  const int wpm = kWarps / nsb;          // warps a row block of dv
  const int tpw = 8 / wpm;               // dv tiles a warp: 1, 2 or 4
  const bool dv_w = warp / wpm < nsb;
  const int dv_m0 = (dv_w ? warp / wpm : 0) * SB;
  int dv_m[kMaxTiles], dv_n[kMaxTiles];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    dv_m[i] = dv_m0;
    dv_n[i] = ((warp % wpm) * tpw + (i < tpw ? i : 0)) * 8;
  }
  float a_da[3][4] = {}, a_ds[NCK][4] = {}, a_vg[NCK][4] = {};
  float pi = 0.0f;
  for (int v0 = 0; v0 < vv; v0 += MVT) {
    if (v0) {
      __syncthreads();  // the last tile's readers are done
      stage(v0);
      cp_async_wait<0>();
      __syncthreads();
    }
    mma_tiles<3, false, false>(
        a_da, da_m, da_n, 0, MVT,
        [&](int t, int j) { return Ds[t * LDT + j]; },
        [&](int j, int s) { return bf2f(Vb[s * LDT + j]); });
    mma_tiles<NCK, false, KT == 64>(
        a_ds, ck_m, ck_n, 0, MVT,
        [&](int t, int j) { return Ds[t * LDT + j]; },
        [&](int j, int ch) { return Ss[ch * LDT + j]; });
    mma_tiles<NCK, false, KT == 64>(
        a_vg, ck_m, ck_n, 0, MVT,
        [&](int t, int j) { return bf2f(Vb[t * LDT + j]); },
        [&](int j, int ch) { return Gs[ch * LDT + j]; });
    // dv = (A^T + diag bonus) do over t >= the row block's first token,
    // + (k 2^{L - cum}) G
    float a_dv[kMaxTiles][4] = {};
    mma_tiles<kMaxTiles, true, false>(
        a_dv, dv_m, dv_n, dv_m0, c_len,
        [&](int s, int t) { return At[s * la + t]; },
        [&](int t, int j) { return Ds[t * LDT + j]; });
    mma_tiles<kMaxTiles, true, false>(
        a_dv, dv_m, dv_n, 0, kk,
        [&](int s, int ch) {
          return kv(s, ch) * fast_exp2(cx(c_len, ch) - cx(s + 1, ch));
        },
        [&](int ch, int j) { return Gs[ch * LDT + j]; });
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      if (!dv_w || i >= tpw) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + frag_col(dv_n[i], e);
        if (col < vv)
          dv[v_off + static_cast<long long>(frag_row(dv_m[i], e)) * vv + col] =
              __float2bfloat16(a_dv[i][e]);
      }
    }
    if (tid < kk)
#pragma unroll 4
      for (int j = 0; j < MVT; ++j)
        pi = fmaf(Ss[tid * LDT + j], Gs[tid * LDT + j], pi);
  }
  __syncthreads();  // the tiles are done: dA, do S^T and v G^T replace them
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i >= n_da_w) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dA[frag_row(da_m[i], e) * la + frag_col(da_n[i], e)] = a_da[i][e];
  }
#pragma unroll
  for (int i = 0; i < NCK; ++i) {
    if (i >= n_ck_w) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = frag_row(ck_m[i], e) * lk + frag_col(ck_n[i], e);
      Fp[o] = a_ds[i][e];
      Bp[o] = a_vg[i][e];
    }
  }
  if (tid < kk) Pi[tid] = pi;
  __syncthreads();

  // P^(J) = dA[>= J0, < J0] Kf^(J) and B^(J) = dA[> eJ, J]^T Rg^(J), task
  // (J, 8 channels) = C x K tile i of the warp: J's own rows stay in
  // registers, P^(J)'s later rows go to Pb
  float p_own[NCK][4] = {}, b_own[NCK][4] = {};
#pragma unroll
  for (int i = 0; i < NCK; ++i) {
    if (i >= n_ck_w) continue;
    const int j0 = ck_m[i];
    const int j1 = j0 + SB;
    const int jb = j0 / SB;
    if (jb >= 1) {
      float acc[3][4] = {};
      int m0[3], n0[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        m0[x] = (jb + x < nsb ? jb + x : jb) * SB;
        n0[x] = ck_n[i];
      }
      mma_tiles<3, false, true>(
          acc, m0, n0, 0, j0, [&](int t, int s) { return dA[t * la + s]; },
          [&](int s, int ch) {
            return kv(s, ch) * fast_exp2(cx(j0, ch) - cx(s + 1, ch));
          });
#pragma unroll
      for (int e = 0; e < 4; ++e) p_own[i][e] = acc[0][e];
#pragma unroll
      for (int x = 1; x < 3; ++x) {
        if (x >= nsb - jb) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Pb[(pb_base(c_len, jb) + frag_row(m0[x], e) - j1) * lk +
             frag_col(n0[x], e)] = acc[x][e];
      }
    }
    if (jb + 1 < nsb) {
      float acc[1][4] = {};
      const int m0[1] = {j0}, n0[1] = {ck_n[i]};
      mma_tiles<1, true, true>(
          acc, m0, n0, j1, c_len, [&](int s, int t) { return dA[t * la + s]; },
          [&](int t, int ch) {
            return rv(t, ch) * fast_exp2(cx(t, ch) - cx(j1, ch));
          });
#pragma unroll
      for (int e = 0; e < 4; ++e) b_own[i][e] = acc[0][e];
    }
  }
  __syncthreads();

  // X'_J, one thread per (J, channel): the pairs that span J
  if (tid < nsb * kk) {
    const int jb = tid / kk;
    const int ch = tid % kk;
    const int j0 = jb * SB;
    const int j1 = j0 + SB;
    const float cq = cx(j0, ch);
    const float ce = cx(j1, ch);
    const float eq = fast_exp2(cq);
    float x = 0.0f;
#pragma unroll 4
    for (int t = j1; t < c_len; ++t) {
      const float p =
          jb ? Pb[(pb_base(c_len, jb) + t - j1) * lk + ch] : 0.0f;
      x = fmaf(rv(t, ch) * fast_exp2(cx(t, ch) - ce),
               fmaf(eq, Fp[t * lk + ch], p), x);
    }
    float z = eq * Pi[ch];
#pragma unroll 4
    for (int s = 0; s < j0; ++s)
      z = fmaf(kv(s, ch) * fast_exp2(cq - cx(s + 1, ch)), Bp[s * lk + ch], z);
    Xp[jb * kk + ch] = fmaf(fast_exp2(cx(c_len, ch) - ce), z, x);
  }
  __syncthreads();
  // F' = P^(J) + 2^{cq} do S^T and B' = B^(J) + 2^{L - ce} v G^T on J's rows
#pragma unroll
  for (int i = 0; i < NCK; ++i) {
    if (i >= n_ck_w) continue;
    const int j0 = ck_m[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = frag_col(ck_n[i], e);
      const int o = frag_row(j0, e) * lk + ch;
      Fp[o] = fmaf(fast_exp2(cx(j0, ch)), Fp[o], p_own[i][e]);
      Bp[o] = fmaf(fast_exp2(cx(c_len, ch) - cx(j0 + SB, ch)), Bp[o],
                   b_own[i][e]);
    }
  }
  __syncthreads();

  // The walk, one thread per (J, channel), j through J in order: dr, dk, dw
  // (cases (i)-(iv)) and the share of du; J's cx, r and F' in registers
  if (tid < nsb * kk) {
    const int jb = tid / kk;
    const int ch = tid % kk;
    const int j0 = jb * SB;
    float c[SB + 1], rr[SB], fp[SB], m[SB];
#pragma unroll
    for (int x = 0; x <= SB; ++x) c[x] = cx(j0 + x, ch);
#pragma unroll
    for (int x = 0; x < SB; ++x) {
      rr[x] = rv(j0 + x, ch);
      fp[x] = Fp[(j0 + x) * lk + ch];
      m[x] = 0.0f;
    }
    const float cq = c[0];
    const float ce = c[SB];
    const float uu = Us[ch];
    const float xj = Xp[jb * kk + ch];
    float n = 0.0f, dup = 0.0f;
#pragma unroll
    for (int jj = 0; jj < SB; ++jj) {
      const int j = j0 + jj;
      const float kj = kv(j, ch);
      const float db = dA[j * la + j];
      const float bpj = Bp[j * lk + ch];
      const float fq = fast_exp2(c[jj] - cq);
      const float fe = fast_exp2(ce - c[jj + 1]);
      const float dec = fast_exp2(c[jj + 1] - c[jj]);
      float sdk = 0.0f, sf = 0.0f, sm = 0.0f;
#pragma unroll
      for (int tt = jj + 1; tt < SB; ++tt) {
        const float rt = rr[tt] * fast_exp2(c[tt] - c[jj + 1]);
        const float da = dA[(j0 + tt) * la + j];
        sdk = fmaf(da, rt, sdk);
        sf = fmaf(rt, fp[tt], sf);
        sm = fmaf(rt, m[tt], sm);
        m[tt] = fmaf(dec, m[tt], da * kj);
      }
      const float bon = uu * db;
      const long long o = rk_off + static_cast<long long>(j) * kk + ch;
      st(dr + o, fmaf(bon, kj, fmaf(fq, fp[jj], m[jj])));
      st(dk + o, fmaf(bon, rr[jj], fmaf(fe, bpj, sdk)));
      st(dw + o, fmaf(fe, n, fmaf(fq, sf, sm)) +
                     fast_exp2((ce - c[jj + 1]) + (c[jj] - cq)) * xj);
      dup = fmaf(rr[jj] * kj, db, dup);
      n = fmaf(dec, n, kj * bpj);
    }
    Dup[jb * kk + ch] = dup;
  }
  __syncthreads();
  for (int ch = tid; ch < kk; ch += kThreads) {
    float d = 0.0f;
    for (int jb = 0; jb < nsb; ++jb) d += Dup[jb * kk + ch];
    du_p[(bh * nc + ci) * kk + ch] = d;
  }
}

template <typename W, int KT>
int launch_mma_k(const void* r, const void* k, const void* v, const void* w,
                 const float* u, const float* dout, const float* dstate,
                 void* dr, void* dk, void* dv, void* dw, float* du,
                 float* scratch, int b, int h, int t_len, int kk, int vv,
                 int c_len, cudaStream_t stream, int device) {
  if (kk % 8 || kk > kMaxK || c_len % SB || c_len > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const int nc = t_len / c_len;
  const long long bh = static_cast<long long>(b) * h;
  float* decay = scratch;
  float* su = decay + bh * nc * kk;
  float* sq = su + bh * nc * kk * vv;
  float* du_p = sq + bh * nc * kk * vv;

  const int prep_bytes =
      prep_smem_floats(c_len, kk) * static_cast<int>(sizeof(float));
  static std::atomic<int> prep_set[64];  // zero: static storage
  cudaError_t err =
      allow_smem(prep_set, bwd_mma_prep_kernel<W, KT>, prep_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_mma_prep_kernel<W, KT><<<dim3(nc, h, b), kThreads, prep_bytes, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const W*>(w), dout, decay, su,
      sq, h, t_len, kk, vv, c_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd_scan_kernel<<<dim3((kk * vv + kThreads - 1) / kThreads, h, b), kThreads,
                    0, stream>>>(decay, su, sq, dstate, kk, vv, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int chunk_bytes =
      chunk_smem_floats(c_len, kk) * static_cast<int>(sizeof(float));
  static std::atomic<int> chunk_set[64];
  err = allow_smem(chunk_set, bwd_mma_chunk_kernel<W, KT>, chunk_bytes,
                   device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_mma_chunk_kernel<W, KT>
      <<<dim3(nc, h, b), kThreads, chunk_bytes, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const W*>(w), u, dout, su, sq,
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<W*>(dw), du_p, h, t_len, kk, vv, c_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd_du_kernel<<<dim3((h * kk + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(du_p, du, b, h, kk, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_mma(const void* r, const void* k, const void* v, const void* w,
               const float* u, const float* dout, const float* dstate,
               void* dr, void* dk, void* dv, void* dw, float* du,
               float* scratch, int b, int h, int t_len, int kk, int vv,
               int c_len, cudaStream_t s, int device) {
  switch (kk) {
    case 16: return launch_mma_k<W, 16>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
    case 64: return launch_mma_k<W, 64>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
    default: return launch_mma_k<W, 0>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  }
}

}  // namespace

extern "C" {

// Runs K6's backward on the "fma" route (four launches) on `stream`.  r, k,
// w are (b, h, t_len, kk), v (b, h, t_len, vv), u (h, kk) float32, dout (b,
// h, t_len, vv) float32, dstate (b, h, kk, vv) float32 or null (no
// cotangent of the final state); dr, dk (r's type), dv (v's), dw (w's) of
// their inputs' shapes and du (h, kk) float32 are written; all contiguous.  scratch holds
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

// Runs K6's backward on the "mma" route (four launches) on `stream`: r, k, v
// bfloat16, w float32 (w_dtype 0) or bfloat16 (1), the rest as
// rwkv6_scan_bwd's; dr, dk, dv bfloat16, dw in w's type.  scratch holds
// b*h*(nc*kk*(1 + 2*vv) + nc*kk) float32.  kk must be a multiple of 8 up to
// 64 and c_len a multiple of 16 up to 64 (else cudaErrorInvalidValue); the
// caller checks t_len % c_len == 0.
int rwkv6_scan_bwd_mma(const void* r, const void* k, const void* v,
                       const void* w, const float* u, const float* dout,
                       const float* dstate, void* dr, void* dk, void* dv,
                       void* dw, float* du, float* scratch, int b, int h,
                       int t_len, int kk, int vv, int c_len, int w_dtype,
                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    return launch_mma<float>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  if (w_dtype == 1)
    return launch_mma<__nv_bfloat16>(r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, scratch, b, h, t_len, kk, vv, c_len, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
