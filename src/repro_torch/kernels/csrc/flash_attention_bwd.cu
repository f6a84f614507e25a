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
// shape (B 8, S 256, 16 / 8 heads of 128) that is bound by bytes, at S 2048
// by operations.
//
// Two kernels a type, both launched by one call, in stream order: a dq pass,
// one block per (q tile, head, batch), that rebuilds each row's logsumexp
// (the forward keeps neither statistic) and D_i, writes both to float32
// scratch and sums dq; then a dk / dv pass, one block per (kv tile, kv head,
// batch), that loops over the kv head's q heads and, within each, over the q
// tiles that see the tile, and sums dk and dv in registers.  No atomics:
// every output element is summed by one thread in a fixed order, so two runs
// are bit-identical.  Masked entries (and rows that see nothing) give p = 0
// and ds = 0 by a condition, never through -inf arithmetic.  Ragged S: rows
// >= seq load as 0, are masked and are never stored.
//
// * bfloat16 (attn_bwd_dq_tc_kernel, attn_bwd_dkdv_tc_kernel): FlashAttention-2's
//   two deterministic passes on the tensor cores, mma.sync m16n8k16 with fp32
//   accumulators, in the forward's idiom (csrc/flash_attention.cu,
//   flash_attn_tc_kernel):
//   - 4 warps a block, each owning 16 rows (q rows in the dq pass, kv rows in
//     the dk / dv pass); tiles as bfloat16 rows padded by 16 bytes, so the 8
//     row addresses of every ldmatrix fall in distinct banks;
//   - dq pass: Q and dout loaded once; K (and V) tiles of 64 rows (32 at
//     D = 256) through a 2-stage cp.async ring that walks the visible tiles
//     twice: first S = Q K^T alone, for each row's running max and sum (log2
//     units, the SFU's ex2), then S = Q K^T and dP = dout V^T, P = exp2(x
//     log2(e) - lse2), dS, and dq += dS K with dS, rounded to bfloat16, the A
//     operand straight from the accumulators (the forward's P V trick) and K
//     the B operand through ldmatrix.trans.  The logsumexp goes to the
//     scratch in log2 units, D_i (2 lanes a row, from out and dout in
//     global memory) as it is;
//   - dk / dv pass: K and V of the 64-row tile loaded once; Q, dout and the
//     q rows' lse2 and D in steps of 64 q rows (32 at D >= 128: 64 spill
//     at D = 128) through a 2-stage cp.async ring over (q head, q tile);
//     S^T = K Q^T and dP^T = V dout^T, then dV += P^T dout and dK += dS^T Q
//     with P^T and dS^T in bfloat16 as A operands from the accumulators and
//     dout, Q through ldmatrix.trans.  dk and dv stay in fp32 registers and
//     are stored once.  At D = 256 the two accumulators (256 floats a thread)
//     do not fit: each block owns one half of D's output columns, and the
//     two halves' blocks each compute the whole S^T and dP^T;
//   - masks only on the tiles that need them: a warp whose 16 rows see every
//     column of a tile skips the per-element test, a warp whose rows see none
//     skips the tile (it still meets the block's barriers);
//   - P and dS are rounded to bfloat16 once, as the A operands of their
//     products (FlashAttention-2's rounding, and the forward's of P); every
//     sum is fp32.
// * float32 (attn_bwd_dq_f32_kernel, attn_bwd_dkdv_f32_kernel): IEEE fp32
//   FMAs (the 1e-4 limit rules out one-pass TF32) on 64 x 64 tiles, 256
//   threads as a 16 x 16 grid, the layout of the forward's float32 kernel:
//   the dq pass sweeps the kv tiles twice (the logsumexp, natural units,
//   then dq += dS K through shared memory); the dk / dv pass keeps K^T and
//   V^T in shared memory and forms P^T and dS^T from the saved lse and D.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute calls or the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: IEEE FMAs on 64 x 64 tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid: thread (ty, tx)
constexpr int BT = 64;         // rows of a q tile and of a kv tile
constexpr int KP = 32;         // panel depth: columns of D, or rows
constexpr int LD = BT + 1;     // padded row stride of transposed tiles
constexpr int TM = BT / 16;    // tile rows per thread
constexpr int TN = BT / 16;    // tile columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}


// columns [c0, c0 + cols) of rows [r0, r0 + BT) of a (seq, D) matrix, as
// float32, transposed into dst[c * LD + r]; rows past seq are 0
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* src, int r0, int c0,
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
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
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

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout, float* __restrict__ dq,
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
      const float* orow = o + q_off + static_cast<long long>(q0 + r) * D;
      for (int d = tid % 4; d < D; d += 4)
        acc = fmaf(Gt[d * LD + r], orow[d], acc);
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
      dq[q_off + static_cast<long long>(qpos) * D + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// dk and dv, over the q heads of one kv head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ delta_in, float* __restrict__ dk,
                     float* __restrict__ dv, int h, int hkv, int seq, int causal,
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
        const float* src = pass == 0 ? dout + q_off : q + q_off;
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
      dk[at] = dk_acc[i][j];
      dv[at] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// Per head dim: 4 warps of 16 rows; the dq pass's kv tile (BN) and the dk /
// dv pass's q step (BQ) shrink as D grows, so that the fp32 accumulators
// (dq: D / 2 a thread; dk and dv: DO a thread) and the S and dP tiles fit
// the registers without spilling.
template <int D>
struct TcShape {
  static constexpr int NW = 4;
  static constexpr int threads = NW * 32;
  static constexpr int BM = NW * 16;            // rows a block owns
  static constexpr int BN = D > 128 ? 32 : 64;  // dq pass: kv rows a tile
  static constexpr int BQ = D > 64 ? 32 : 64;   // dk / dv pass: q rows a step
  static constexpr int DO = D > 128 ? 128 : D;  // dk / dv pass: output columns
  static constexpr int LDS = D + 8;             // padded row (bfloat16)
  static constexpr int dq_smem = (2 * BM + 4 * BN) * LDS * 2;
  static constexpr int kv_smem = (2 * BM + 4 * BQ) * LDS * 2 + 4 * BQ * 4;
};

// 4-byte global -> shared copy, zero-filled when `full` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + rows) of a (seq, D) bfloat16 matrix into padded shared
// memory by the whole block; rows past seq are zero-filled
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int rows, int seq) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH;
    const int c = (e % CH) * 8;
    const bool in = r0 + r < seq;
    cp_async16(dst + r * (D + 8) + c,
               src + static_cast<long long>(in ? r0 + r : 0) * D + c, in);
  }
}

// acc (16 x 8 NT) = A B^T for one warp: A the 16 rows of shared memory at a,
// B the 8 NT rows at b, both D wide (stride D + 8), bfloat16 in, fp32 out.
// A's ldmatrix: row lane % 16, column 8 (lane / 16); B's, two n8 tiles at
// once: row 8 (lane / 16) + lane % 8, column 8 ((lane / 8) % 2).
template <int NT, int D>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        const bf16* b, int lane) {
  constexpr int LDS = D + 8;
  static_assert(NT % 2 == 0, "ldmatrix x4 gives two n8 tiles at once");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(a + (lane % 16) * LDS + kd * 16 + 8 * (lane / 16)));
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bb[4];
      ldmatrix_x4(bb, smem_addr(b + (nt * 8 + 8 * (lane / 16) + lane % 8) * LDS +
                                kd * 16 + 8 * ((lane / 8) % 2)));
      mma_bf16(acc[nt], af, bb[0], bb[1]);
      mma_bf16(acc[nt + 1], af, bb[2], bb[3]);
    }
  }
}

// acc (16 x 8 OT) += P B for one warp: P (16 x 8 NT) the fp32 accumulators
// of an mma_abt, rounded to bfloat16 as the A operand (the m16n8 accumulator
// layout of two n-tiles is the m16k16 A layout); B the 8 NT rows of shared
// memory at b (stride D + 8), 8 OT columns from b, through ldmatrix.trans.
template <int NT, int OT, int D>
__device__ __forceinline__ void mma_pb(float (&acc)[OT][4],
                                       const float (&p)[NT][4], const bf16* b,
                                       int lane) {
  constexpr int LDS = D + 8;
  static_assert(OT % 2 == 0, "ldmatrix x4 gives two n8 tiles at once");
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int ot = 0; ot < OT; ot += 2) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, smem_addr(b + (kk * 16 + 8 * ((lane / 8) % 2) + lane % 8) *
                                              LDS + ot * 8 + 8 * (lane / 16)));
      mma_bf16(acc[ot], pa, bb[0], bb[1]);
      mma_bf16(acc[ot + 1], pa, bb[2], bb[3]);
    }
  }
}

__device__ __forceinline__ bool sees(int qpos, int kpos, int seq, int causal,
                                     int window) {
  return qpos < seq && kpos < seq && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// the logit of a raw product (softcapped where softcap > 0)
__device__ __forceinline__ float capped(float s, float scale, float softcap) {
  const float x = s * scale;
  return softcap > 0.0f ? softcap * tanhf(x / softcap) : x;
}

// d logit / d raw product: scale (1 - tanh^2) with tanh = x / softcap
__device__ __forceinline__ float dlogit(float x, float scale, float softcap) {
  if (softcap <= 0.0f) return scale;
  const float th = x / softcap;
  return scale * (1.0f - th * th);
}

// ---------------------------------------------------------------------------
// dq, with each row's logsumexp (log2 units) and D
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(TcShape<D>::threads)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                      float* __restrict__ lse_out,
                      float* __restrict__ delta_out, int h, int hkv, int seq,
                      int causal, int window, float scale, float softcap) {
  using S = TcShape<D>;
  constexpr int BM = S::BM, BN = S::BN, LDS = S::LDS, T = S::threads;
  constexpr int NT = BN / 8;  // S tile n8 tiles
  constexpr int DT = D / 8;   // dq n8 tiles
  static_assert(NT * 4 <= 32, "the live mask of a thread fits 32 bits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* Gs = Qs + BM * LDS;                      // [BM][LDS]    dout
  bf16* Ks = Gs + BM * LDS;                      // [2][BN][LDS]
  bf16* Vs = Ks + 2 * BN * LDS;                  // [2][BN][LDS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest rows first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int wr = (threadIdx.x / 32) * 16;  // this warp's first row
  const int g = lane / 4, t4 = lane % 4;   // accumulator row and column pair
  const long long row_off = (static_cast<long long>(bi) * h + hi) * seq;
  const long long kv_off =
      (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * seq * D;
  const bf16* Kg = k + kv_off;
  const bf16* Vg = v + kv_off;

  // the visible kv tiles: the forward's closed form at bq = BM, bk = BN
  const int q_last = min(q0 + BM, seq) - 1;
  const int kv_hi = causal ? q_last / BN + 1 : (seq + BN - 1) / BN;
  int kv_lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kv_lo = first > 0 ? first / BN : 0;
  }
  const int n = kv_hi - kv_lo;  // >= 1: row q0 sees itself

  // the ring walks the visible tiles twice: steps [0, n) rebuild the
  // logsumexp (K only), steps [n, 2 n) sum dq (K and V)
  auto load_step = [&](int i, int st) {
    const int k0 = (kv_lo + (i < n ? i : i - n)) * BN;
    load_tile<D, T>(Ks + st * BN * LDS, Kg, k0, BN, seq);
    if (i >= n) load_tile<D, T>(Vs + st * BN * LDS, Vg, k0, BN, seq);
  };
  load_tile<D, T>(Qs, q + row_off * D, q0, BM, seq);
  load_tile<D, T>(Gs, dout + row_off * D, q0, BM, seq);
  load_step(0, 0);
  cp_async_commit();

  // D_i = dout_i . out_i: lanes 2 r and 2 r + 1 sum the two halves of the
  // warp's row r from global memory; then each thread takes its rows g, g + 8
  float d_a, d_b;
  {
    const int r = q0 + wr + lane / 2;
    float sum = 0.0f;
    if (r < seq) {
      const long long at = (row_off + r) * D + (lane % 2) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 gu = *reinterpret_cast<const uint4*>(dout + at + c);
        const uint4 ou = *reinterpret_cast<const uint4*>(o + at + c);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gu);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ou);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 gf = __bfloat1622float2(gp[j]);
          const float2 of = __bfloat1622float2(op[j]);
          sum = fmaf(gf.x, of.x, sum);
          sum = fmaf(gf.y, of.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (lane % 2 == 0 && r < seq) delta_out[row_off + r] = sum;
    d_a = __shfl_sync(0xffffffffu, sum, 2 * g);
    d_b = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
  }

  const int qa = q0 + wr + g;  // this thread's two q rows
  const int qb = qa + 8;
  float m_a = kNegInf, m_b = kNegInf;  // running max of rows qa, qb (log2)
  float l_a = 0.0f, l_b = 0.0f;        // this thread's partial row sums
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int i = 0; i < 2 * n; ++i) {
    const int st = i & 1;
    if (i + 1 < 2 * n) load_step(i + 1, st ^ 1);  // stage st ^ 1 is free
    cp_async_commit();
    cp_async_wait<1>();  // everything but the loads just issued has landed
    __syncthreads();
    if (i == n) {  // the logsumexp: the row sums over the 4 lanes of a row
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      m_a = l_a > 0.0f ? m_a + log2f(l_a) : 0.0f;
      m_b = l_b > 0.0f ? m_b + log2f(l_b) : 0.0f;
      if (t4 == 0 && qa < seq) lse_out[row_off + qa] = m_a;
      if (t4 == 0 && qb < seq) lse_out[row_off + qb] = m_b;
    }
    const int k0 = (kv_lo + (i < n ? i : i - n)) * BN;
    const bool none = (causal && k0 > q0 + wr + 15) ||
                      (window > 0 && k0 + BN - 1 <= q0 + wr - window) ||
                      q0 + wr >= seq;
    if (!none) {
      const bool interior =
          k0 + BN <= seq && (!causal || k0 + BN - 1 <= q0 + wr) &&
          (window <= 0 || k0 > q0 + wr + 15 - window);
      const bf16* Kst = Ks + st * BN * LDS;
      float s[NT][4];
      mma_abt<NT, D>(s, Qs + wr * LDS, Kst, lane);
      if (i < n) {
        // the running max and sum of each row (log2 units)
        unsigned live = 0xffffffffu;
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = capped(s[nt][e], scale, softcap) * kLog2e;
            s[nt][e] = x;
            if (!interior && !sees(e < 2 ? qa : qb, k0 + nt * 8 + 2 * t4 + (e & 1),
                                   seq, causal, window)) {
              live &= ~(1u << (nt * 4 + e));
              continue;
            }
            if (e < 2) mx_a = fmaxf(mx_a, x);
            else mx_b = fmaxf(mx_b, x);
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!((live >> (nt * 4 + e)) & 1u)) continue;
            if (e < 2) sum_a += fast_exp2(s[nt][e] - mn_a);
            else sum_b += fast_exp2(s[nt][e] - mn_b);
          }
        l_a = l_a * fast_exp2(m_a - mn_a) + sum_a;
        l_b = l_b * fast_exp2(m_b - mn_b) + sum_b;
        m_a = mn_a;
        m_b = mn_b;
      } else {
        // dP = dout V^T; P and dS; dq += dS K
        float dp[NT][4];
        mma_abt<NT, D>(dp, Gs + wr * LDS, Vs + st * BN * LDS, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = capped(s[nt][e], scale, softcap);
            const bool ok =
                interior || sees(e < 2 ? qa : qb, k0 + nt * 8 + 2 * t4 + (e & 1),
                                 seq, causal, window);
            const float p = ok ? fast_exp2(x * kLog2e - (e < 2 ? m_a : m_b)) : 0.0f;
            s[nt][e] = p * (dp[nt][e] - (e < 2 ? d_a : d_b)) *
                       dlogit(x, scale, softcap);
          }
        mma_pb<NT, DT, D>(acc, s, Kst, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  bf16* DQ = dq + row_off * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (qa < seq)
      *reinterpret_cast<uint32_t*>(DQ + static_cast<long long>(qa) * D + c) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (qb < seq)
      *reinterpret_cast<uint32_t*>(DQ + static_cast<long long>(qb) * D + c) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// dk and dv, over the q heads of one kv head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(TcShape<D>::threads)
attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse_in,
                        const float* __restrict__ delta_in,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int h,
                        int hkv, int seq, int causal, int window, float scale,
                        float softcap) {
  using S = TcShape<D>;
  constexpr int BM = S::BM, BQ = S::BQ, DO = S::DO, LDS = S::LDS;
  constexpr int T = S::threads;
  constexpr int NT = BQ / 8;    // S^T tile n8 tiles (q columns)
  constexpr int OT = DO / 8;    // dk, dv n8 tiles
  constexpr int HALVES = D / DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][LDS]
  bf16* Vs = Ks + BM * LDS;                      // [BM][LDS]
  bf16* Qs = Vs + BM * LDS;                      // [2][BQ][LDS]
  bf16* Gs = Qs + 2 * BQ * LDS;                  // [2][BQ][LDS]  dout
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LDS);  // [2][BQ] lse2
  float* Ds = Ls + 2 * BQ;                                  // [2][BQ] D

  const int k0 = (blockIdx.x / HALVES) * BM;  // kv tile 0 first: the most q tiles
  const int c0 = (blockIdx.x % HALVES) * DO;  // this block's output columns
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int wr = (threadIdx.x / 32) * 16;
  const int g = lane / 4, t4 = lane % 4;
  const int group = h / hkv;
  const long long kv_off = (static_cast<long long>(bi) * hkv + hk) * seq * D;

  // the q tiles with a row that sees a key of this tile, in each q head
  const int nq = (seq + BQ - 1) / BQ;
  const int qt_lo = causal ? k0 / BQ : 0;
  int qt_hi = nq;
  if (window > 0) {
    const int q_max = min(k0 + BM, seq) - 1 + window - 1;
    qt_hi = min(nq, q_max / BQ + 1);
  }
  const int nqt = qt_hi - qt_lo;
  const int n = group * nqt;  // ring steps: (q head, q tile), q tiles inner

  auto load_step = [&](int i, int st) {
    const long long row_off =
        (static_cast<long long>(bi) * h + hk * group + i / nqt) * seq;
    const int q0 = (qt_lo + i % nqt) * BQ;
    load_tile<D, T>(Qs + st * BQ * LDS, q + row_off * D, q0, BQ, seq);
    load_tile<D, T>(Gs + st * BQ * LDS, dout + row_off * D, q0, BQ, seq);
    for (int e = threadIdx.x; e < BQ; e += T) {
      const bool in = q0 + e < seq;
      const long long at = row_off + (in ? q0 + e : 0);
      cp_async4(Ls + st * BQ + e, lse_in + at, in);
      cp_async4(Ds + st * BQ + e, delta_in + at, in);
    }
  };
  load_tile<D, T>(Ks, k + kv_off, k0, BM, seq);
  load_tile<D, T>(Vs, v + kv_off, k0, BM, seq);
  if (n > 0) load_step(0, 0);
  cp_async_commit();

  const int ka = k0 + wr + g;  // this thread's two kv rows
  const int kb = ka + 8;
  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    if (i + 1 < n) load_step(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt_lo + i % nqt) * BQ;
    const bool none = (causal && k0 + wr > q0 + BQ - 1) ||
                      (window > 0 && k0 + wr + 15 <= q0 - window) ||
                      k0 + wr >= seq;
    if (!none) {
      const bool interior =
          q0 + BQ <= seq && k0 + wr + 16 <= seq &&
          (!causal || k0 + wr + 15 <= q0) &&
          (window <= 0 || q0 + BQ - 1 < k0 + wr + window);
      const bf16* Qst = Qs + st * BQ * LDS;
      const bf16* Gst = Gs + st * BQ * LDS;
      const float* L = Ls + st * BQ;
      const float* Dl = Ds + st * BQ;
      float s[NT][4], dp[NT][4];
      mma_abt<NT, D>(s, Ks + wr * LDS, Qst, lane);   // S^T = K Q^T
      mma_abt<NT, D>(dp, Vs + wr * LDS, Gst, lane);  // dP^T = V dout^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          const float x = capped(s[nt][e], scale, softcap);
          const bool ok = interior || sees(q0 + col, e < 2 ? ka : kb, seq,
                                           causal, window);
          const float p = ok ? fast_exp2(x * kLog2e - L[col]) : 0.0f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - Dl[col]) * dlogit(x, scale, softcap);
        }
      mma_pb<NT, OT, D>(dv_acc, s, Gst + c0, lane);   // dV += P^T dout
      mma_pb<NT, OT, D>(dk_acc, dp, Qst + c0, lane);  // dK += dS^T Q
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    const long long c = c0 + ot * 8 + 2 * t4;
    if (ka < seq) {
      const long long at = kv_off + static_cast<long long>(ka) * D + c;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk_acc[ot][0], dk_acc[ot][1]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv_acc[ot][0], dv_acc[ot][1]);
    }
    if (kb < seq) {
      const long long at = kv_off + static_cast<long long>(kb) * D + c;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk_acc[ot][2], dk_acc[ot][3]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv_acc[ot][2], dv_acc[ot][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* dout, void* dq, void* dk, void* dv, void* lse,
               void* delta, int b, int h, int hkv, int seq, int causal,
               int window, float scale, float softcap, cudaStream_t stream,
               int device) {
  constexpr int dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int kv_bytes = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  auto* k_dq = attn_bwd_dq_f32_kernel<D>;
  auto* k_kv = attn_bwd_dkdv_f32_kernel<D>;
  static std::atomic<int> dq_set[64], kv_set[64];
  cudaError_t err = allow_smem(dq_set, k_dq, dq_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(kv_set, k_kv, kv_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq + BT - 1) / BT;
  k_dq<<<dim3(tiles, h, b), kThreads, dq_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), h, hkv, seq,
      causal, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_kv<<<dim3(tiles, hkv, b), kThreads, kv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, hkv, seq, causal,
      window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* out,
              const void* dout, void* dq, void* dk, void* dv, void* lse,
              void* delta, int b, int h, int hkv, int seq, int causal,
              int window, float scale, float softcap, cudaStream_t stream,
              int device) {
  using S = TcShape<D>;
  static_assert(S::dq_smem <= 232448 && S::kv_smem <= 232448,
                "above the 227 KiB a block may use");
  auto* k_dq = attn_bwd_dq_tc_kernel<D>;
  auto* k_kv = attn_bwd_dkdv_tc_kernel<D>;
  static std::atomic<int> dq_set[64], kv_set[64];
  cudaError_t err = allow_smem(dq_set, k_dq, S::dq_smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(kv_set, k_kv, S::kv_smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (seq + S::BM - 1) / S::BM;
  k_dq<<<dim3(tiles, h, b), S::threads, S::dq_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), h, hkv, seq,
      causal, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_kv<<<dim3(tiles * (D / S::DO), hkv, b), S::threads, S::kv_smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, hkv, seq, causal,
      window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* out, const void* dout, void* dq, void* dk, void* dv,
             void* lse, void* delta, int b, int h, int hkv, int seq,
             int causal, int window, float scale, float softcap,
             cudaStream_t s, int device) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, dout, dq, dk, dv, lse, delta, b, h,
                         hkv, seq, causal, window, scale, softcap, s, device);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, out, dout, dq, dk, dv, lse, delta, b, h,
                        hkv, seq, causal, window, scale, softcap, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, out, dout and dq are (b, h, seq, d), k, v, dk and dv (b, hkv, seq, d),
// all contiguous, 16-byte aligned, of one type: dtype 0 = float32, 1 =
// bfloat16; lse and delta are float32 (b, h, seq) scratch (the logsumexp in
// natural units for float32, log2 units for bfloat16); d is 16, 32, 64, 128
// or 256 and h a multiple of hkv (checked by the caller).  Launches the dq
// pass, then the dk / dv pass, on `stream`.
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
