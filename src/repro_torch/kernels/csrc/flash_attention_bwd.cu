// The backward of causal / sliding-window flash attention (kernel K4) for
// Hopper, sm_90a.
//
// Forward (csrc/flash_attention.cu), per (b, h) and q row i:
//   x_ij = softcap(scale * q_i . k_j)   (x = scale * q . k without softcap)
//   p_ij = mask(i, j) ? exp(x_ij - lse_i) : 0,   out_i = sum_j p_ij v_j
// Backward, given dout:
//   D_i   = sum_d dout_id out_id
//   dp_ij = dout_i . v_j
//   ds_ij = p_ij (dp_ij - D_i) (1 - tanh^2) scale   (the tanh of the softcap)
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i,   dv_j = sum_i p_ij dout_i
// with dk and dv summed over the q heads of each kv head (GQA).
//
// Replaces the XLA autodiff of the reference's flash_attention_jnp
// (src/repro/models/attention.py:18; the models train through it,
// src/repro/models/blocks.py:20-24): the reference has no backward Pallas
// kernel, so there is no pallas_call to name.
//
// Bound: five S x S x D products per head (the forward's Q K^T again, then
// dout V^T, dS K, dS^T Q and P^T dout), half of them under a causal mask: in
// bfloat16 on the tensor cores (989 TFLOP/s) against q, k, v, out and dout
// read once and dq, dk, dv written once (3.35 TB/s); at qwen3-1.7b's training
// shape (B 8, S 256, 16 / 8 heads of 128) that is bound by operations.  This
// first kernel is the simple one: IEEE fp32 FMAs on 64 x 64 tiles in both
// types (the layout of the forward's float32 kernel), bfloat16 widened to
// float32 as it is loaded.  The tensor cores are later work.
//
// Two kernels, both launched by one call, in stream order:
// * attn_bwd_dq_kernel, one block per (q tile, head, batch): D_i from out and
//   dout; a first pass over the visible kv tiles rebuilds each row's
//   logsumexp (the forward keeps neither statistic); a second pass recomputes
//   P tile by tile, dP = dout V^T, dS, and dq += dS K.  It writes lse and D to
//   float32 scratch for the second kernel.
// * attn_bwd_dkdv_kernel, one block per (kv tile, kv head, batch): K^T and
//   V^T stay in shared memory; a loop over the kv head's q heads and, within
//   each, over the q tiles that see the tile, recomputes S^T = K Q^T and
//   dP^T = V dout^T, forms P^T and dS^T from the saved lse and D, and sums
//   dv += P^T dout and dk += dS^T Q in registers.
// No atomics: every output element is summed by one thread in a fixed order,
// so two runs are bit-identical.  Masked entries (and rows that see nothing)
// give p = 0 and ds = 0 by a condition, never through -inf arithmetic.
// Ragged S: rows >= seq load as 0, are masked and are never stored.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute calls or the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid: thread (ty, tx)
constexpr int BT = 64;         // rows of a q tile and of a kv tile
constexpr int KP = 32;         // panel depth: columns of D, or rows
constexpr int LD = BT + 1;     // padded row stride of transposed tiles
constexpr int TM = BT / 16;    // tile rows per thread
constexpr int TN = BT / 16;    // tile columns per thread
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// columns [c0, c0 + cols) of rows [r0, r0 + BT) of a (seq, D) matrix, as
// float32, transposed into dst[c * LD + r]; rows past seq are 0
template <int D, typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src, int r0, int c0,
                                       int cols, int seq) {
  for (int e = threadIdx.x; e < BT * cols / 4; e += kThreads) {
    const int r = e / (cols / 4);
    const int c = (e % (cols / 4)) * 4;
    const float4 x = r0 + r < seq
        ? load4(src + static_cast<long long>(r0 + r) * D + c0 + c)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[(c + 0) * LD + r] = x.x;
    dst[(c + 1) * LD + r] = x.y;
    dst[(c + 2) * LD + r] = x.z;
    dst[(c + 3) * LD + r] = x.w;
  }
}

// rows [r0, r0 + KP) of a (seq, D) matrix, as float32, into dst[r * D + c];
// rows past seq are 0
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int seq) {
  for (int e = threadIdx.x; e < KP * D / 4; e += kThreads) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * D + c) = r0 + r < seq
        ? load4(src + static_cast<long long>(r0 + r) * D + c)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int seq, int causal,
                                        int window) {
  return qpos < seq && kpos < seq && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// the logit of a raw product s; th is the softcap's tanh (0 without one)
__device__ __forceinline__ float logit(float s, float scale, float softcap,
                                       float& th) {
  const float x = s * scale;
  if (softcap > 0.0f) {
    th = tanhf(x / softcap);
    return softcap * th;
  }
  th = 0.0f;
  return x;
}

template <int D>
constexpr int kq() { return D < KP ? D : KP; }

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * LD + 2 * kq<D>() * LD + BT * LD + KP * D;
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * D * LD + 2 * kq<D>() * LD + 2 * BT * LD + KP * D;
}

// ---------------------------------------------------------------------------
// dq, with each row's logsumexp and D
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   float* __restrict__ lse_out, float* __restrict__ delta_out,
                   int h, int hkv, int seq, int causal, int window,
                   float scale, float softcap) {
  constexpr int TD = D / 16;
  constexpr int KQ = D < KP ? D : KP;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [D][LD]   Q^T of this q tile
  float* Gt = Qt + D * LD;       // [D][LD]   dout^T of this q tile
  float* Kt = Gt + D * LD;       // [KQ][LD]  K^T panel
  float* Vt = Kt + KQ * LD;      // [KQ][LD]  V^T panel
  float* Ss = Vt + KQ * LD;      // [BT][LD]  dS of one kv tile
  float* Ks = Ss + BT * LD;      // [KP][D]   K rows
  __shared__ float Dl[BT];       // D of this tile's rows

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long row_off = (static_cast<long long>(bi) * h + hi) * seq;
  const long long q_off = row_off * D;
  const long long kv_off =
      (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * seq * D;

  load_t<D>(Qt, q + q_off, q0, 0, D, seq);
  load_t<D>(Gt, dout + q_off, q0, 0, D, seq);
  __syncthreads();

  // D_i = dout_i . out_i: 4 threads a row, then the 4 lanes' sums
  {
    const int r = tid / 4;
    float acc = 0.0f;
    if (q0 + r < seq) {
      const T* orow = o + q_off + static_cast<long long>(q0 + r) * D;
      for (int d = tid % 4; d < D; d += 4)
        acc = fmaf(Gt[d * LD + r], to_float(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (tid % 4 == 0) {
      Dl[r] = acc;
      if (q0 + r < seq) delta_out[row_off + q0 + r] = acc;
    }
  }

  // the visible kv tiles: the forward's closed form at bq = bk = 64
  const int q_last = min(q0 + BT, seq) - 1;
  const int kv_hi = causal ? q_last / BT + 1 : (seq + BT - 1) / BT;
  int kv_lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kv_lo = first > 0 ? first / BT : 0;
  }

  // pass 1: each row's running max and sum, then its logsumexp
  float m_r[TM], l_r[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.0f;
  }
  for (int kb = kv_lo; kb < kv_hi; ++kb) {
    const int k0 = kb * BT;
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KQ) {
      __syncthreads();  // earlier readers of Kt are done
      load_t<D>(Kt, k + kv_off, k0, d0, KQ, seq);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < KQ; ++c) {
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
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
      unsigned live = 0u;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float th;
        const float x = logit(s[i][j], scale, softcap, th);
        s[i][j] = x;
        if (visible(qpos, k0 + tx + 16 * j, seq, causal, window)) {
          live |= 1u << j;
          mx = fmaxf(mx, x);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if ((live >> j) & 1u) sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[i] = l_r[i] * expf(m_r[i] - m_new) + sum;
      m_r[i] = m_new;
    }
  }
  float lse[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lse[i] = l_r[i] > 0.0f ? m_r[i] + logf(l_r[i]) : __int_as_float(0x7f800000);
    if (tx == 0 && qpos < seq) lse_out[row_off + qpos] = lse[i];
  }

  // pass 2: P, dP = dout V^T, dS; dq += dS K
  float acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.0f;
  for (int kb = kv_lo; kb < kv_hi; ++kb) {
    const int k0 = kb * BT;
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KQ) {
      __syncthreads();  // earlier readers of Kt, Vt (and Ks) are done
      load_t<D>(Kt, k + kv_off, k0, d0, KQ, seq);
      load_t<D>(Vt, v + kv_off, k0, d0, KQ, seq);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KQ; ++c) {
        float a[TM], g[TM], b[TN], w[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          a[i] = Qt[(d0 + c) * LD + ty + 16 * i];
          g[i] = Gt[(d0 + c) * LD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          b[j] = Kt[c * LD + tx + 16 * j];
          w[j] = Vt[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float th;
        const float x = logit(s[i][j], scale, softcap, th);
        float ds = 0.0f;
        if (visible(q0 + r, k0 + tx + 16 * j, seq, causal, window))
          ds = expf(x - lse[i]) * (dp[i][j] - Dl[r]) * (1.0f - th * th) * scale;
        Ss[r * LD + tx + 16 * j] = ds;
      }
    }
    for (int c0 = 0; c0 < BT; c0 += KP) {
      __syncthreads();  // Ss is written; earlier readers of Ks are done
      load_rows<D>(Ks, k + kv_off, k0 + c0, seq);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KP; ++c) {
        float a[TM], b[TD];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Ss[(ty + 16 * i) * LD + c0 + c];
#pragma unroll
        for (int j = 0; j < TD; ++j) b[j] = Ks[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= seq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      store(dq + q_off + static_cast<long long>(qpos) * D + tx + 16 * j,
            acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dk and dv, over the q heads of one kv head
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ delta_in, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int hkv, int seq, int causal,
                     int window, float scale, float softcap) {
  constexpr int TD = D / 16;
  constexpr int KQ = D < KP ? D : KP;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;              // [D][LD]   K^T of this kv tile
  float* Vt = Kt + D * LD;       // [D][LD]   V^T of this kv tile
  float* Qp = Vt + D * LD;       // [KQ][LD]  Q^T panel
  float* Gp = Qp + KQ * LD;      // [KQ][LD]  dout^T panel
  float* Pt = Gp + KQ * LD;      // [BT][LD]  P^T (kv rows, q columns)
  float* St = Pt + BT * LD;      // [BT][LD]  dS^T
  float* Rs = St + BT * LD;      // [KP][D]   dout or Q rows
  __shared__ float Lq[BT], Dq[BT];  // lse and D of the q tile's rows

  const int k0 = blockIdx.x * BT;  // kv tile 0 first: the most q tiles
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int group = h / hkv;
  const long long kv_off = (static_cast<long long>(bi) * hkv + hk) * seq * D;

  load_t<D>(Kt, k + kv_off, k0, 0, D, seq);
  load_t<D>(Vt, v + kv_off, k0, 0, D, seq);

  // the q tiles with a row that sees a key of this tile
  const int nq = (seq + BT - 1) / BT;
  const int qt_lo = causal ? k0 / BT : 0;
  int qt_hi = nq;
  if (window > 0) {
    const int q_max = min(k0 + BT, seq) - 1 + window - 1;
    qt_hi = min(nq, q_max / BT + 1);
  }

  float dk_acc[TM][TD], dv_acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int gq = 0; gq < group; ++gq) {
    const long long row_off =
        (static_cast<long long>(bi) * h + hk * group + gq) * seq;
    const long long q_off = row_off * D;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // earlier readers of Lq, Dq, Pt, St and Rs are done
      if (tid < BT) {
        const bool in = q0 + tid < seq;
        Lq[tid] = in ? lse_in[row_off + q0 + tid] : 0.0f;
        Dq[tid] = in ? delta_in[row_off + q0 + tid] : 0.0f;
      }
      // S^T = K Q^T and dP^T = V dout^T over D in panels
      float s[TM][TN], dp[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.0f;
      for (int d0 = 0; d0 < D; d0 += KQ) {
        __syncthreads();  // earlier readers of Qp and Gp are done
        load_t<D>(Qp, q + q_off, q0, d0, KQ, seq);
        load_t<D>(Gp, dout + q_off, q0, d0, KQ, seq);
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < KQ; ++c) {
          float a[TM], e[TM], b[TN], w[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            a[i] = Kt[(d0 + c) * LD + ty + 16 * i];
            e[i] = Vt[(d0 + c) * LD + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            b[j] = Qp[c * LD + tx + 16 * j];
            w[j] = Gp[c * LD + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              s[i][j] = fmaf(a[i], b[j], s[i][j]);
              dp[i][j] = fmaf(e[i], w[j], dp[i][j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = tx + 16 * j;
          float th;
          const float x = logit(s[i][j], scale, softcap, th);
          float p = 0.0f, ds = 0.0f;
          if (visible(q0 + col, k0 + r, seq, causal, window)) {
            p = expf(x - Lq[col]);
            ds = p * (dp[i][j] - Dq[col]) * (1.0f - th * th) * scale;
          }
          Pt[r * LD + col] = p;
          St[r * LD + col] = ds;
        }
      }
      // dv += P^T dout, then dk += dS^T Q, over the tile's q rows in panels
      for (int pass = 0; pass < 2; ++pass) {
        const T* src = pass == 0 ? dout + q_off : q + q_off;
        const float* A = pass == 0 ? Pt : St;
        for (int c0 = 0; c0 < BT; c0 += KP) {
          __syncthreads();  // Pt and St are written; readers of Rs are done
          load_rows<D>(Rs, src, q0 + c0, seq);
          __syncthreads();
#pragma unroll 4
          for (int c = 0; c < KP; ++c) {
            float a[TM], b[TD];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * LD + c0 + c];
#pragma unroll
            for (int j = 0; j < TD; ++j) b[j] = Rs[c * D + tx + 16 * j];
            if (pass == 0) {
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TD; ++j)
                  dv_acc[i][j] = fmaf(a[i], b[j], dv_acc[i][j]);
            } else {
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TD; ++j)
                  dk_acc[i][j] = fmaf(a[i], b[j], dk_acc[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= seq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const long long at = kv_off + static_cast<long long>(kpos) * D + tx + 16 * j;
      store(dk + at, dk_acc[i][j]);
      store(dv + at, dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* delta, int b, int h, int hkv, int seq, int causal, int window,
           float scale, float softcap, cudaStream_t stream, int device) {
  constexpr int dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int kv_bytes = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  auto* k_dq = attn_bwd_dq_kernel<T, D>;
  auto* k_kv = attn_bwd_dkdv_kernel<T, D>;
  static std::atomic<int> dq_set[64], kv_set[64];
  cudaError_t err = allow_smem(dq_set, k_dq, dq_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(kv_set, k_kv, kv_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq + BT - 1) / BT;
  k_dq<<<dim3(tiles, h, b), kThreads, dq_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), h, hkv, seq,
      causal, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_kv<<<dim3(tiles, hkv, b), kThreads, kv_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, hkv, seq, causal, window,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* out, const void* dout, void* dq, void* dk, void* dv,
             void* lse, void* delta, int b, int h, int hkv, int seq,
             int causal, int window, float scale, float softcap,
             cudaStream_t s, int device) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, dout, dq, dk, dv, lse, delta, b, h,
                            hkv, seq, causal, window, scale, softcap, s, device);
  if (dtype == 1)
    return launch<bf16, D>(q, k, v, out, dout, dq, dk, dv, lse, delta, b, h,
                           hkv, seq, causal, window, scale, softcap, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, out, dout and dq are (b, h, seq, d), k, v, dk and dv (b, hkv, seq, d),
// all contiguous, 16-byte aligned, of one type: dtype 0 = float32, 1 =
// bfloat16; lse and delta are float32 (b, h, seq) scratch; d is 16, 32, 64,
// 128 or 256 and h a multiple of hkv (checked by the caller).  Launches the
// dq pass, then the dk / dv pass, on `stream`.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, void* dq, void* dk,
                        void* dv, void* lse, void* delta, int b, int h,
                        int hkv, int seq, int d, int causal, int window,
                        float scale, float softcap, int dtype, void* stream,
                        int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(dtype, q, k, v, out, dout, dq, dk, dv, lse, delta, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 32: return launch_d<32>(dtype, q, k, v, out, dout, dq, dk, dv, lse, delta, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 64: return launch_d<64>(dtype, q, k, v, out, dout, dq, dk, dv, lse, delta, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 128: return launch_d<128>(dtype, q, k, v, out, dout, dq, dk, dv, lse, delta, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 256: return launch_d<256>(dtype, q, k, v, out, dout, dq, dk, dv, lse, delta, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
