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
// Here one thread block owns one (b, h, q tile), computes the same closed-form
// range for its tile itself (no schedule upload), and loops over the range's
// kv tiles.  Blocks need no order among themselves; the grid is walked from
// the last q tile down, so under a causal mask the tiles with the longest kv
// range start first.
//
// Bound: 4 * D FLOP per visible (q, k) pair on q, k, v read once and the
// output written once.  At hymba-1.5b's prefill (D = 64, window 1024, S =
// 2048) that is 10 GFLOP on 16 MB in bfloat16: bound by operations, on the
// tensor cores.  Two kernels, picked by the input type:
//
// * bfloat16 (flash_attn_tc_kernel), on the tensor cores with mma.sync
//   m16n8k16 (FlashAttention-2's shape; wgmma with TMA is later work):
//   - each warp 16 q rows: 8 warps (a 128-row q tile) up to D = 64, 4 warps
//     (64 rows) at D = 128 and 256, two blocks per SM; BK = 64 kv rows per
//     tile (32 at D = 256, for registers); D in {16, 32, 64, 128, 256};
//   - Q (loaded once), K and V in shared memory as bfloat16 rows padded by 16
//     bytes, so the 8 row addresses of every ldmatrix fall in distinct banks;
//     K and V in a 2-stage cp.async ring: the loads of kv tile j + 1 are in
//     flight while tile j is multiplied (2 barriers per kv tile);
//   - S = Q K^T: Q fragments by ldmatrix (kept in registers for D <= 128), K's
//     [kv][d] rows are already the B operand's layout (ldmatrix, no
//     transpose); fp32 accumulators;
//   - online softmax in fp32 registers on log2(e)-scaled scores with the
//     SFU's ex2.approx (about 2 ulp, far inside the bfloat16 limit);
//     row max and sum over the 4 lanes that share a row; each thread keeps a
//     partial row sum, summed once at the end;
//   - O += P V: the S accumulators, rounded to bfloat16, are the A operand
//     in registers (the m16n8 accumulator layout of two n-tiles is the m16k16
//     A layout); V [kv][d] is the B operand through ldmatrix.trans;
//   - masks only on tiles that need them: a warp whose 16 rows see every
//     column of a kv tile (interior tiles) skips the per-element test;
//     boundary tiles (the diagonal, the window's first tile, the tile holding
//     seq) give a masked entry p = 0 by a condition, never through -inf
//     arithmetic, so a row whose first tiles are all masked carries
//     m = -1e30, l = 0, acc = 0;
//   - the output tile goes through shared memory (each warp its own rows) and
//     out in 16-byte stores.
//   P is rounded to bfloat16 before the PV product, as flash_attention_jnp
//   does (the Pallas kernel keeps it in float32): within the 2e-2 limit.
// * float32 (flash_attn_f32_kernel), IEEE fp32 FMAs (the 1e-4 limit rules
//   out one-pass TF32) on 64 x 64 tiles, 256 threads as a 16 x 16
//   grid, thread (ty, tx) owning rows ty + 16*i and columns tx + 16*j; Q^T in
//   shared memory for the whole kv loop, K streamed in panels of min(32, D)
//   columns of D (stored transposed), P through shared memory, V in 32-row
//   panels; masks per element.
// Ragged S: q rows >= seq load as 0 and are never stored; kv rows >= seq load
// as 0 and are masked.  Rows whose sum is 0 come out exactly 0.  Shared memory
// is above the 48 KiB static limit for most D: the launch opts in to dynamic
// shared memory.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: IEEE FMAs on 64 x 64 tiles
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;  // q rows per block
constexpr int BK32 = 64;  // kv rows per tile
constexpr int KP = 32;    // panel depth: columns of D for Q K^T, kv rows for P V

template <int D>
constexpr int f32_smem_floats() {
  return (D + KP + BQ32) * (BK32 + 1) + KP * D;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      int h, int hkv, int seq, int causal, int window,
                      float scale, float softcap) {
  constexpr int TM = BQ32 / 16;  // q rows per thread
  constexpr int TN = BK32 / 16;  // score columns (kv rows) per thread
  constexpr int TD = D / 16;     // output columns per thread
  constexpr int KQ = D < KP ? D : KP;  // columns of D per Q K^T panel
  constexpr int LD = BK32 + 1;   // padded row stride of Qt, Kt and Ps
  static_assert(BQ32 == BK32, "Qt shares the padded stride of Kt and Ps");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [D][LD]   Q^T of this q tile
  float* Kt = Qt + D * LD;     // [KP][LD]  K^T panel
  float* Ps = Kt + KP * LD;    // [BQ][LD]  probabilities of one kv tile
  float* Vs = Ps + BQ32 * LD;  // [KP][D]   V panel

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ32;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long q_off = (static_cast<long long>(bi) * h + hi) * seq * D;
  const long long kv_off =
      (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * seq * D;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // Q^T into shared memory; rows past seq are 0.
  for (int e = tid; e < BQ32 * D / 4; e += kThreads) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const float4 x = q0 + r < seq
        ? *reinterpret_cast<const float4*>(
              q + q_off + static_cast<long long>(q0 + r) * D + c)
        : zero4;
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
  const int q_last = min(q0 + BQ32, seq) - 1;
  const int kv_hi = causal ? q_last / BK32 + 1 : (seq + BK32 - 1) / BK32;
  int kv_lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kv_lo = first > 0 ? first / BK32 : 0;
  }

  for (int kb = kv_lo; kb < kv_hi; ++kb) {
    const int k0 = kb * BK32;

    // S = Q K^T over D in panels of KQ.
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KQ) {
      __syncthreads();  // Qt is written; earlier readers of Kt and Ps are done
      for (int e = tid; e < BK32 * KQ / 4; e += kThreads) {
        const int r = e / (KQ / 4);
        const int c = (e % (KQ / 4)) * 4;
        const float4 x = k0 + r < seq
            ? *reinterpret_cast<const float4*>(
                  k + kv_off + static_cast<long long>(k0 + r) * D + d0 + c)
            : zero4;
        Kt[(c + 0) * LD + r] = x.x;
        Kt[(c + 1) * LD + r] = x.y;
        Kt[(c + 2) * LD + r] = x.z;
        Kt[(c + 3) * LD + r] = x.w;
      }
      __syncthreads();
#pragma unroll
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
    for (int c0 = 0; c0 < BK32; c0 += KP) {
      __syncthreads();  // Ps is written; earlier readers of Vs are done
      for (int e = tid; e < KP * D / 4; e += kThreads) {
        const int r = e / (D / 4);
        const int c = (e % (D / 4)) * 4;
        const int row = k0 + c0 + r;
        *reinterpret_cast<float4*>(&Vs[r * D + c]) = row < seq
            ? *reinterpret_cast<const float4*>(
                  v + kv_off + static_cast<long long>(row) * D + c)
            : zero4;
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

  float* O = out + q_off;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j)
      O[static_cast<long long>(r) * D + tx + 16 * j] =
          l_row[i] > 0.0f ? acc[i][j] / l_row[i] : 0.0f;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int h, int hkv, int seq, int causal, int window, float scale,
               float softcap, cudaStream_t stream, int device) {
  constexpr int bytes = f32_smem_floats<D>() * static_cast<int>(sizeof(float));
  auto* kernel = flash_attn_f32_kernel<D>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ32 - 1) / BQ32, h, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), h, hkv, seq,
      causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Per head dim: 8 warps (a 128-row q tile) up to D = 64, capped at 128
// registers so that two blocks share an SM; 4 warps (64 rows) above, where
// the accumulators need more registers, again two blocks per SM.
template <int D>
struct TcShape {
  static constexpr int NW = D <= 64 ? 8 : 4;    // warps, 16 q rows each
  static constexpr int threads = NW * 32;
  static constexpr int BQ = NW * 16;            // q rows per block
  static constexpr int BK = D > 128 ? 32 : 64;  // kv rows per tile
  static constexpr int LDS = D + 8;             // padded row (bfloat16)
  static constexpr bool kQRegs = D <= 128;      // Q fragments in registers
  static constexpr int smem_bytes =
      (BQ + 4 * BK) * LDS * static_cast<int>(sizeof(bf16));
};

template <int D>
__global__ void __launch_bounds__(TcShape<D>::threads, 2)
flash_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int h,
                     int hkv, int seq, int causal, int window, float scale,
                     float softcap) {
  using S = TcShape<D>;
  constexpr int BQ = S::BQ;
  constexpr int BK = S::BK;
  constexpr int LDS = S::LDS;
  constexpr int NT = BK / 8;    // score n-tiles (8 kv columns each)
  constexpr int DT = D / 8;     // output n-tiles (8 columns of D each)
  constexpr int KD = D / 16;    // k-steps of Q K^T
  constexpr int KK = BK / 16;   // k-steps of P V
  constexpr int CH = D / 8;     // 16-byte chunks per row
  static_assert(NT * 4 <= 32, "the live mask of a thread fits 32 bits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDS]
  bf16* Ks = Qs + BQ * LDS;                      // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                  // [2][BK][LDS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator row (and row + 8)
  const int t4 = lane % 4;  // accumulator column pair
  const int wr = warp * 16; // this warp's first row in the q tile
  const bf16* Qg = q + (static_cast<long long>(bi) * h + hi) * seq * D;
  const long long kv_off =
      (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * seq * D;
  const bf16* Kg = k + kv_off;
  const bf16* Vg = v + kv_off;

  // rows [r0, r0 + rows) of a (seq, D) matrix into padded shared memory;
  // rows past seq are zero-filled
  auto load_rows = [&](bf16* dst, const bf16* src, int r0, int rows) {
    for (int e = tid; e < rows * CH; e += S::threads) {
      const int r = e / CH;
      const int c = (e % CH) * 8;
      const bool in = r0 + r < seq;
      cp_async16(dst + r * LDS + c,
                 src + static_cast<long long>(in ? r0 + r : 0) * D + c, in);
    }
  };

  // The visible kv tiles of this q tile (attention_block_schedule's closed
  // form at bq = 128, bk = BK, the last q row clipped to seq).
  const int q_last = min(q0 + BQ, seq) - 1;
  const int kv_hi = causal ? q_last / BK + 1 : (seq + BK - 1) / BK;
  int kv_lo = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    kv_lo = first > 0 ? first / BK : 0;
  }

  load_rows(Qs, Qg, q0, BQ);
  load_rows(Ks, Kg, kv_lo * BK, BK);
  load_rows(Vs, Vg, kv_lo * BK, BK);
  cp_async_commit();

  // ldmatrix lane addressing: A (16 x 16): row lane % 16, column 8 * (lane / 16);
  // B pairs: row (n) 8 * (lane / 16) + lane % 8, column (k) 8 * ((lane / 8) % 2);
  // B^T pairs (V): row (k) 8 * ((lane / 8) % 2) + lane % 8, column (n) 8 * (lane / 16)
  const int a_row = lane % 16;
  const int a_col = 8 * (lane / 16);
  const int b_row = 8 * (lane / 16) + lane % 8;
  const int b_col = 8 * ((lane / 8) % 2);

  uint32_t qf[S::kQRegs ? KD : 1][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf;  // running max of rows g, g + 8 (log2)
  float l_a = 0.0f, l_b = 0.0f;        // this thread's partial row sums
  const float scale_log2 = scale * kLog2e;
  const int qa = q0 + wr + g;          // this thread's two q rows
  const int qb = qa + 8;

  for (int kb = kv_lo; kb < kv_hi; ++kb) {
    const int st = (kb - kv_lo) & 1;
    if (kb + 1 < kv_hi) {  // the other stage was released at the last barrier
      load_rows(Ks + (st ^ 1) * BK * LDS, Kg, (kb + 1) * BK, BK);
      load_rows(Vs + (st ^ 1) * BK * LDS, Vg, (kb + 1) * BK, BK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the loads just issued has landed
    __syncthreads();
    if constexpr (S::kQRegs) {
      if (kb == kv_lo) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldmatrix_x4(qf[kd], smem_addr(Qs + (wr + a_row) * LDS + kd * 16 + a_col));
      }
    }
    const bf16* Kst = Ks + st * BK * LDS;
    const bf16* Vst = Vs + st * BK * LDS;

    // S = Q K^T (fp32 accumulators)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (S::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        ldmatrix_x4(a, smem_addr(Qs + (wr + a_row) * LDS + kd * 16 + a_col));
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, smem_addr(Kst + (nt * 8 + b_row) * LDS + kd * 16 + b_col));
        mma_bf16(s[nt], a, bb[0], bb[1]);
        mma_bf16(s[nt + 1], a, bb[2], bb[3]);
      }
    }

    // scale (log2 units), softcap, masks; the running max of each row
    const int k0 = kb * BK;
    const bool interior =
        k0 + BK <= seq && (!causal || k0 + BK - 1 <= q0 + wr) &&
        (window <= 0 || k0 > q0 + wr + 15 - window);
    unsigned live = 0xffffffffu;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        x = softcap > 0.0f ? softcap * tanhf(x * scale / softcap) * kLog2e
                           : x * scale_log2;
        s[nt][e] = x;
        if (!interior) {
          const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? qa : qb;
          const bool ok = kpos < seq && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) live &= ~(1u << (nt * 4 + e));
          if (!ok) continue;
        }
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = fast_exp2(m_a - mn_a);
    const float alpha_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (live >> (nt * 4 + e)) & 1u;
        const float p = ok ? fast_exp2(s[nt][e] - (e < 2 ? mn_a : mn_b)) : 0.0f;
        s[nt][e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }

    // O += P V: P from registers (bfloat16), V^T through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_addr(Vst + (kk * 16 + b_col + lane % 8) * LDS +
                                        dt * 8 + 8 * (lane / 16)));
        mma_bf16(o[dt], pa, bb[0], bb[1]);
        mma_bf16(o[dt + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  // the row sums over the 4 lanes of a row; normalise; through shared memory
  // (this warp's own 16 rows of Qs) to 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  bf16* Os = Qs + wr * LDS;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(Os + g * LDS + c) =
        pack_bf16(o[dt][0] * inv_a, o[dt][1] * inv_a);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * LDS + c) =
        pack_bf16(o[dt][2] * inv_b, o[dt][3] * inv_b);
  }
  __syncwarp();
  bf16* Og = out + (static_cast<long long>(bi) * h + hi) * seq * D;
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH;
    const int c = (e % CH) * 8;
    const int row = q0 + wr + r;
    if (row < seq)
      *reinterpret_cast<uint4*>(Og + static_cast<long long>(row) * D + c) =
          *reinterpret_cast<const uint4*>(Os + r * LDS + c);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int h, int hkv, int seq, int causal, int window, float scale,
              float softcap, cudaStream_t stream, int device) {
  using S = TcShape<D>;
  auto* kernel = flash_attn_tc_kernel<D>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, S::smem_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + S::BQ - 1) / S::BQ, h, b);
  kernel<<<grid, S::threads, S::smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), h, hkv, seq,
      causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int b, int h, int hkv, int seq, int causal, int window, float scale,
           float softcap, cudaStream_t s, int device) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches one thread block per (q tile, head, batch) on `stream`: 64-row q
// tiles for float32, 128- or 64-row tiles on the tensor cores for bfloat16.  q and
// out are (b, h, seq, d), k and v (b, hkv, seq, d), all contiguous, 16-byte
// aligned, of one type: dtype 0 = float32, 1 = bfloat16; d is 16, 32, 64, 128
// or 256 and h a multiple of hkv (checked by the caller).
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int b, int h, int hkv, int seq, int d, int causal,
                    int window, float scale, float softcap, int dtype,
                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 32: return launch<32>(dtype, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 64: return launch<64>(dtype, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 128: return launch<128>(dtype, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    case 256: return launch<256>(dtype, q, k, v, out, b, h, hkv, seq, causal, window, scale, softcap, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
