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
// VMEM scratch; here one thread block owns BM rows of one (b, h, q block) and
// loops over the live slots itself, so padded slots (which alias kv block 0)
// are never read and blocks need no order among themselves.
//
// Bound: 4*BS*BS*D FLOP per visible block and head on 2*BS*D elements of K
// and V, so at BS = D = 128 it is bound by operations.  Both products run on
// the tensor cores, FlashAttention-2's shape: one block per q block (or per
// 64 of its rows), K and V rows streamed in sub-tiles through cp.async, the
// running max and sum and the accumulator in fp32 registers.  The online
// softmax is shared by all paths (softmax_step): in float32 IEEE expf and
// tanhf; a masked score gives p = 0 by a condition, never through -inf
// arithmetic, and rows whose sum is 0 (a q block with no live slot) come out
// exactly 0.  float32 runs 3xTF32: each operand is split into a TF32 big and
// small part and the tensor cores sum small*big + big*small + big*big; the
// tensor cores' own accumulation truncates, so the products' partial sums
// are carried into IEEE fp32 sums (depths below).
//
// * float32 at BS = 128, D = 64 and 128 (the runtime's default block;
//   Llama-3-8B's heads): wgmma.  Two warpgroups of 64 q rows; sub-tiles of
//   KW = 32 kv rows.  Both products take their A operand from registers:
//   Q's fragments, loaded from the raw Q rows in shared memory and split in
//   registers 8 steps at a time, and P, the score accumulators themselves
//   (the accumulator of an 8-column tile holds columns 2t, 2t + 1 where the
//   A fragment wants t, t + 4, so P V's reduction index is relabelled:
//   logical k t stands for kv row 2t, k t + 4 for 2t + 1).  K (B of Q K^T)
//   and V (B of P V; TF32 takes B only K-major, so V is transposed and its
//   kv rows relabelled as it is split, K5's transpose) are split once per
//   block into big and small core matrices, in two buffers: the next
//   sub-tile is split while the tensor cores run this one's Q K^T.  Q K^T is
//   summed on the tensor cores over all of D, P V over the sub-tile's 32 kv
//   rows, then carried.  227 KiB of shared memory at D = 128.
// * the other shapes, and bfloat16: mma.sync.  Each warp owns 16 q rows; Q
//   stays in shared memory; K and V rows stream through a 2-stage ring in
//   sub-tiles of KVT kv rows (64 at BM = 128 and D <= 128 and in bfloat16,
//   else min(BS, 32)).
//   - float32: m16n8k8; every fragment is split in registers as it is
//     loaded (Q's once per 8-deep step, shared by the KVT / 8 score tiles),
//     with the reduction index of both products relabelled as above so that
//     each fragment is a pair of neighbours in memory.  Q K^T is carried
//     every kCarry = 64 of D, P V every 64 kv rows (once a sub-tile).
//   - bfloat16: m16n8k16 with fp32 accumulation, K4's fragments
//     (flash_attention.cu): ldmatrix for Q and K, ldmatrix.trans for V, P
//     rounded to bfloat16 in registers as the A operand of P V (as K4 and
//     flash_attention_jnp round it; the plain version keeps P in fp32, and
//     the difference stays far inside the 2e-2 limit), the softmax in log2
//     units with the SFU's 2^x (K4's).  Rows padded by 16 bytes so that
//     every ldmatrix hits distinct banks.
//   BM = BS q rows a block (64 at D = 256 in float32, for shared memory).
//   DO is the block's share of the output's D: all of it up to D = 128; at
//   D = 256 a grid axis splits the output into two halves of 128 columns
//   and each block still reduces the scores over the full D.
// bs in {16, 32, 64, 128}, D in {16, 32, 64, 128, 256}.  Shared memory is
// above the 48 KiB static limit, so each launch opts in to dynamic shared
// memory.  The output is rounded to the input type once, on store.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute call or the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

#ifndef REPRO_K3_CARRY
#define REPRO_K3_CARRY 64
#endif
// float32 on mma.sync: the depth between carries into the IEEE sums (0: none
// inside a sub-tile, so Q K^T over all of D and P V over the sub-tile's kv
// rows)
constexpr int kCarry = REPRO_K3_CARRY;

// The float32 split (of the fragments in registers and of K and V into
// shared memory): big by truncation and small as is (the default: two
// instructions), or with -DREPRO_K3_SPLIT_RN split_tf32's rounding of both.
// scripts/card_studies.py k3-numerics builds the variants beside the shipped
// kernel to compare their error and time.
__device__ __forceinline__ void split_frag(float x, uint32_t& big,
                                           uint32_t& small) {
#ifdef REPRO_K3_SPLIT_RN
  split_tf32(x, big, small);
#else
  split_tf32_trunc(x, big, small);
#endif
}

// A thread's running softmax state of its two rows (g and g + 8 of its
// warp's 16): the running max and this thread's partial row sums.
struct RowState {
  float m_a = kNegInf, m_b = kNegInf;
  float l_a = 0.0f, l_b = 0.0f;
};

// One sub-tile's online-softmax step on m16n8 score accumulators (s[nt]:
// rows g, g + 8, kv columns k0 + 8 nt + 2 t4 (+ 1)): scale, softcap, the
// kpos < seq mask where the sub-tile reaches seq (a masked score gives p = 0
// by a condition, never through -inf arithmetic, so a row whose scores are
// all masked keeps m = -1e30, l = 0), then s holds p and alpha the factors
// the accumulators of rows g and g + 8 are rescaled by.  kExp2: scores in
// log2 units and the SFU's 2^x (bfloat16, as K4); else IEEE expf.
template <bool kExp2, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], int k0,
                                             int kvt, int seq, int t4,
                                             float scale, float softcap,
                                             RowState& r, float& alpha_a,
                                             float& alpha_b) {
  static_assert(NT * 4 <= 32, "the live mask of a thread fits 32 bits");
  auto exp_of = [](float x) {
    if constexpr (kExp2) return fast_exp2(x);
    else return expf(x);
  };
  const bool interior = k0 + kvt <= seq;
  unsigned live = interior ? 0xffffffffu : 0u;
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      if constexpr (kExp2) x *= kLog2e;
      s[nt][e] = x;
      if (!interior) {
        if (k0 + nt * 8 + 2 * t4 + (e & 1) >= seq) continue;
        live |= 1u << (nt * 4 + e);
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
  const float mn_a = fmaxf(r.m_a, mx_a);
  const float mn_b = fmaxf(r.m_b, mx_b);
  alpha_a = exp_of(r.m_a - mn_a);
  alpha_b = exp_of(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = (live >> (nt * 4 + e)) & 1u;
      const float p = ok ? exp_of(s[nt][e] - (e < 2 ? mn_a : mn_b)) : 0.0f;
      s[nt][e] = p;
      if (e < 2) sum_a += p;
      else sum_b += p;
    }
  }
  r.l_a = r.l_a * alpha_a + sum_a;
  r.l_b = r.l_b * alpha_b + sum_b;
}

// The row sums over the 4 lanes of a row; 1 / sum (0 for a row that saw
// nothing).
__device__ __forceinline__ void row_inverses(RowState r, float& inv_a,
                                             float& inv_b) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l_a += __shfl_xor_sync(0xffffffffu, r.l_a, off);
    r.l_b += __shfl_xor_sync(0xffffffffu, r.l_b, off);
  }
  inv_a = r.l_a > 0.0f ? 1.0f / r.l_a : 0.0f;
  inv_b = r.l_b > 0.0f ? 1.0f / r.l_b : 0.0f;
}

template <typename T, int BS, int D>
struct Shape {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int DO = D > 128 ? 128 : D;   // output columns per block
  static constexpr int n_split = D / DO;
  static constexpr int BM = kF32 && D > 128 && BS > 64 ? 64 : BS;  // q rows
  static constexpr int NW = BM / 16;             // warps, 16 q rows each
  static constexpr int threads = NW * 32;
  static constexpr int KVT =                     // kv rows per sub-tile
      !kF32 ? (BS < 64 ? BS : 64)
            : (BM == 128 && D <= 128 ? 64 : (BS < 32 ? BS : 32));
  static constexpr int LDQ = D + 8;              // padded Q and K rows
  static constexpr int LDV = kF32 ? DO + 4 : DO + 8;  // padded V row
  static constexpr int stage_elems = KVT * (LDQ + LDV);
  static constexpr int smem_bytes =
      (BM * LDQ + 2 * stage_elems) * static_cast<int>(sizeof(T));
};

template <typename T, int BS, int D>
__global__ void __launch_bounds__(Shape<T, BS, D>::threads, 1)
block_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_ids,
                  const int* __restrict__ n_kv, T* __restrict__ out, int h,
                  int hkv, int nq, int nk_cap, int seq, float scale,
                  float softcap) {
  using S = Shape<T, BS, D>;
  constexpr bool kF32 = S::kF32;
  constexpr int BM = S::BM, KVT = S::KVT, DO = S::DO;
  constexpr int LDQ = S::LDQ, LDV = S::LDV, NTH = S::threads;
  constexpr int SUB = BS / KVT;  // sub-tiles per kv block
  constexpr int NT = KVT / 8;    // score n-tiles (8 kv columns each)
  constexpr int DT = DO / 8;     // output n-tiles (8 columns of D each)
  constexpr int CH = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BM][LDQ]
  T* ring = Qs + BM * LDQ;                 // [2] x {K [KVT][LDQ], V [KVT][LDV]}

  const int qi = blockIdx.x / (BS / BM);
  const int row0 = qi * BS + (blockIdx.x % (BS / BM)) * BM;
  const int hi = blockIdx.y / S::n_split;
  const int dcol0 = (blockIdx.y % S::n_split) * DO;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;        // accumulator row (and row + 8)
  const int t4 = lane % 4;       // accumulator column pair
  const int wr = (tid / 32) * 16;  // this warp's first row in the block
  const long long s_pad = static_cast<long long>(nq) * BS;
  const long long q_off = ((static_cast<long long>(bi) * h + hi) * s_pad + row0) * D;
  const long long kv_off = (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * s_pad * D;
  const T* Kg = k + kv_off;
  const T* Vg = v + kv_off + dcol0;
  const int* ids = kv_ids + static_cast<long long>(qi) * nk_cap;
  const int n_sub = n_kv[qi] * SUB;

  // K rows and this block's V columns of sub-tile t into ring stage `st`
  auto load_sub = [&](int t, int st) {
    T* ks = ring + st * S::stage_elems;
    T* vs = ks + KVT * LDQ;
    const long long kr = static_cast<long long>(ids[t / SUB]) * BS + (t % SUB) * KVT;
    for (int e = tid; e < KVT * (D / CH); e += NTH) {
      const int r = e / (D / CH);
      const int c = (e % (D / CH)) * CH;
      cp_async16(ks + r * LDQ + c, Kg + (kr + r) * D + c, true);
    }
    for (int e = tid; e < KVT * (DO / CH); e += NTH) {
      const int r = e / (DO / CH);
      const int c = (e % (DO / CH)) * CH;
      cp_async16(vs + r * LDV + c, Vg + (kr + r) * D + c, true);
    }
  };

  for (int e = tid; e < BM * (D / CH); e += NTH) {
    const int r = e / (D / CH);
    const int c = (e % (D / CH)) * CH;
    cp_async16(Qs + r * LDQ + c, q + q_off + static_cast<long long>(r) * D + c, true);
  }
  if (n_sub > 0) load_sub(0, 0);
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  RowState rs;

  for (int t = 0; t < n_sub; ++t) {
    const int st = t & 1;
    if (t + 1 < n_sub) load_sub(t + 1, st ^ 1);  // released at the last barrier
    cp_async_commit();
    cp_async_wait<1>();  // everything but the loads just issued has landed
    __syncthreads();
    const T* ks = ring + st * S::stage_elems;
    const T* vs = ks + KVT * LDQ;

    // S = Q K^T (fp32 accumulators)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    if constexpr (kF32) {
      constexpr int KC = kCarry == 0 || D < kCarry ? D : kCarry;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += KC) {
        float sp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[j][e] = 0.0f;
#pragma unroll
        for (int kd = d0; kd < d0 + KC; kd += 8) {
          // logical k t4 / t4 + 4 = columns kd + 2 t4 / + 1 of Q and K
          const float2 x0 = *reinterpret_cast<const float2*>(Qs + (wr + g) * LDQ + kd + 2 * t4);
          const float2 x1 = *reinterpret_cast<const float2*>(Qs + (wr + g + 8) * LDQ + kd + 2 * t4);
          uint32_t ab[4], as[4];
          split_frag(x0.x, ab[0], as[0]);
          split_frag(x1.x, ab[1], as[1]);
          split_frag(x0.y, ab[2], as[2]);
          split_frag(x1.y, ab[3], as[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 y = *reinterpret_cast<const float2*>(ks + (nt * 8 + g) * LDQ + kd + 2 * t4);
            uint32_t bb[2], bsm[2];
            split_frag(y.x, bb[0], bsm[0]);
            split_frag(y.y, bb[1], bsm[1]);
            mma_tf32(sp[nt], as, bb);
            mma_tf32(sp[nt], ab, bsm);
            mma_tf32(sp[nt], ab, bb);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += sp[j][e];
      }
    } else {
      // ldmatrix lane addressing (K4's): A row lane % 16, column
      // 8 (lane / 16); B pairs: row (n) 8 (lane / 16) + lane % 8, column (k)
      // 8 ((lane / 8) % 2)
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(Qs + (wr + lane % 16) * LDQ + kd * 16 + 8 * (lane / 16)));
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bb[4];
          ldmatrix_x4(bb, smem_addr(ks + (nt * 8 + 8 * (lane / 16) + lane % 8) * LDQ +
                                    kd * 16 + 8 * ((lane / 8) % 2)));
          mma_bf16(s[nt], a, bb[0], bb[1]);
          mma_bf16(s[nt + 1], a, bb[2], bb[3]);
        }
      }
    }

    float alpha_a, alpha_b;
    softmax_step<!kF32>(s, ids[t / SUB] * BS + (t % SUB) * KVT, KVT, seq, t4,
                        scale, softcap, rs, alpha_a, alpha_b);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }

    // O += P V
    if constexpr (kF32) {
      constexpr int KC = kCarry == 0 || KVT < kCarry ? KVT : kCarry;
#pragma unroll
      for (int c0 = 0; c0 < KVT; c0 += KC) {
        float op[DT][4];
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) op[j][e] = 0.0f;
#pragma unroll
        for (int kk = c0; kk < c0 + KC; kk += 8) {
          // A = P of score tile kk / 8: logical k t4 / t4 + 4 = kv columns
          // kk + 2 t4 / + 1, which the accumulator holds in [0], [2] / [1], [3]
          const float* pt = s[kk / 8];
          uint32_t pb[4], ps[4];
          split_frag(pt[0], pb[0], ps[0]);
          split_frag(pt[2], pb[1], ps[1]);
          split_frag(pt[1], pb[2], ps[2]);
          split_frag(pt[3], pb[3], ps[3]);
          const float* vr = vs + (kk + 2 * t4) * LDV + g;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            uint32_t bb[2], bsm[2];
            split_frag(vr[dt * 8], bb[0], bsm[0]);
            split_frag(vr[dt * 8 + LDV], bb[1], bsm[1]);
            mma_tf32(op[dt], ps, bb);
            mma_tf32(op[dt], pb, bsm);
            mma_tf32(op[dt], pb, bb);
          }
        }
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] += op[j][e];
      }
    } else {
      // P from registers (bfloat16), V^T through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KVT / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, smem_addr(vs + (kk * 16 + 8 * ((lane / 8) % 2) + lane % 8) * LDV +
                                          dt * 8 + 8 * (lane / 16)));
          mma_bf16(o[dt], pa, bb[0], bb[1]);
          mma_bf16(o[dt + 1], pa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  // normalise; store
  float inv_a, inv_b;
  row_inverses(rs, inv_a, inv_b);
  T* O = out + q_off + static_cast<long long>(wr + g) * D + dcol0 + 2 * t4;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if constexpr (kF32) {
      *reinterpret_cast<float2*>(O + dt * 8) = make_float2(o[dt][0] * inv_a, o[dt][1] * inv_a);
      *reinterpret_cast<float2*>(O + 8 * D + dt * 8) =
          make_float2(o[dt][2] * inv_b, o[dt][3] * inv_b);
    } else {
      *reinterpret_cast<uint32_t*>(O + dt * 8) = pack_bf16(o[dt][0] * inv_a, o[dt][1] * inv_a);
      *reinterpret_cast<uint32_t*>(O + 8 * D + dt * 8) =
          pack_bf16(o[dt][2] * inv_b, o[dt][3] * inv_b);
    }
  }
}

// ---------------------------------------------------------------------------
// float32, BS = 128, D = 64 and 128: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

// Two warpgroups, 64 q rows each; KW = 32 kv rows a sub-tile.  Both
// products take their A operand from registers: Q's fragments (loaded from
// the raw Q rows in shared memory and split in registers, eight 8-deep steps
// at a time) and P (the score accumulators).  Shared memory holds Q raw
// (rows padded by 16 bytes), two split buffers, each one sub-tile's K (B of
// Q K^T, K-major core matrices over D) and V (B of P V: transposed, K-major
// over the sub-tile's kv rows) in big and small halves, and the raw K and V
// rows of the next sub-tile: 227 KiB at D = 128, the most a block may use.
// The next sub-tile is split while the tensor cores run this one's Q K^T.
template <int D>
struct WgShape {
  static constexpr int BS = 128, KW = 32, threads = 256;
  static constexpr int LDR = D + 4;                  // padded raw row (floats)
  static constexpr int kv_words = KW * D;            // one half of K or of V
  static constexpr int split_words = 4 * kv_words;   // K and V, big and small
  static constexpr int smem_bytes = (BS * LDR + 2 * split_words + 2 * KW * LDR) * 4;
  static constexpr uint32_t LBO = 128;               // next 4 k
  static constexpr uint32_t SBO_D = D / 4 * 128;     // next 8 rows, k over D
  static constexpr uint32_t SBO_KW = KW / 4 * 128;   // next 8 rows, k over KW
};

template <int D>
__global__ void __launch_bounds__(256, 1)
block_attn_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_ids,
                        const int* __restrict__ n_kv, float* __restrict__ out,
                        int h, int hkv, int nq, int nk_cap, int seq,
                        float scale, float softcap) {
  using S = WgShape<D>;
  constexpr int BS = S::BS, KW = S::KW, LDR = S::LDR;
  constexpr int SUB = BS / KW;        // sub-tiles per kv block
  constexpr int NO = D / 2;           // accumulators of a thread's 64 x D tile
  constexpr int H = D / 8 < 8 ? D / 8 : 8;  // Q K^T steps a commit group
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* q_raw = reinterpret_cast<float*>(smem_raw);                  // [BS][LDR]
  uint32_t* split = reinterpret_cast<uint32_t*>(q_raw + BS * LDR);   // [2]
  float* k_raw = reinterpret_cast<float*>(split + 2 * S::split_words);  // [KW][LDR]
  float* v_raw = k_raw + KW * LDR;                                      // [KW][LDR]

  const int qi = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + g;  // and row + 8
  const long long s_pad = static_cast<long long>(nq) * BS;
  const long long q_off = ((static_cast<long long>(bi) * h + hi) * s_pad +
                           static_cast<long long>(qi) * BS) * D;
  const long long kv_off = (static_cast<long long>(bi) * hkv + hi / (h / hkv)) * s_pad * D;
  const float* Kg = k + kv_off;
  const float* Vg = v + kv_off;
  const int* ids = kv_ids + static_cast<long long>(qi) * nk_cap;
  const int n_sub = n_kv[qi] * SUB;

  auto put = [](uint32_t* big, uint32_t* small, int off, float4 x) {
    uint32_t b[4], sm[4];
    split_frag(x.x, b[0], sm[0]);
    split_frag(x.y, b[1], sm[1]);
    split_frag(x.z, b[2], sm[2]);
    split_frag(x.w, b[3], sm[3]);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  };
  auto load_raw = [&](int t) {
    const long long kr = static_cast<long long>(ids[t / SUB]) * BS + (t % SUB) * KW;
    for (int e = tid; e < KW * D / 4; e += 256) {
      const int r = e / (D / 4);
      const int c = (e % (D / 4)) * 4;
      cp_async16(k_raw + r * LDR + c, Kg + (kr + r) * D + c, true);
      cp_async16(v_raw + r * LDR + c, Vg + (kr + r) * D + c, true);
    }
  };
  // the raw sub-tile into split buffer `b`: K as is (the 32 lanes of a warp
  // on 8 rows x 4 chunks, 4 core matrices in one 512-byte run); V
  // transposed, with its kv rows relabelled as P's A fragments read them
  // (logical k t4 of each 8 is kv row 2 t4, k t4 + 4 is 2 t4 + 1), each
  // thread rotating its 4 x 4 tile so that a warp's stores spread over all
  // banks (K5's transpose)
  auto split_sub = [&](int b) {
    uint32_t* k_big = split + b * S::split_words;
    uint32_t* k_small = k_big + S::kv_words;
    uint32_t* v_big = k_small + S::kv_words;
    uint32_t* v_small = v_big + S::kv_words;
    for (int e = tid; e < KW * D / 4; e += 256) {
      const int g32 = e / 32;
      const int r = 8 * (g32 % (KW / 8)) + e % 8;
      const int c = 4 * (g32 / (KW / 8)) + (e / 8) % 4;
      put(k_big, k_small, core_word<D>(r, 4 * c),
          *reinterpret_cast<const float4*>(k_raw + r * LDR + 4 * c));
    }
    for (int tau = tid; tau < KW * D / 16; tau += 256) {
      const int n4 = tau % (D / 4);
      const int kq = tau / (D / 4);          // logical k quad
      const int r0 = 8 * (kq / 2) + kq % 2;  // its kv rows: r0 + 2 j
      const int rot = (n4 >> 1) & 3;
      float4 x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = rotate4(*reinterpret_cast<const float4*>(v_raw + (r0 + 2 * j) * LDR + 4 * n4), rot);
      const float* xf = reinterpret_cast<const float*>(x);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int n = 4 * n4 + ((qq + rot) & 3);
        put(v_big, v_small, core_word<KW>(n, 4 * kq),
            make_float4(xf[qq], xf[4 + qq], xf[8 + qq], xf[12 + qq]));
      }
    }
  };
  // Q's A fragments of steps k0 .. k0 + H - 1, split in registers
  uint32_t qb[H][4], qs[H][4];
  auto q_frags = [&](int k0) {
    const float* r_a = q_raw + row * LDR + t4;
    const float* r_b = r_a + 8 * LDR;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int c = 8 * (k0 + i);
      split_frag(r_a[c], qb[i][0], qs[i][0]);
      split_frag(r_b[c], qb[i][1], qs[i][1]);
      split_frag(r_a[c + 4], qb[i][2], qs[i][2]);
      split_frag(r_b[c + 4], qb[i][3], qs[i][3]);
    }
  };
  auto fence_q = [&]() {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      fence_operand(qb[i]);
      fence_operand(qs[i]);
    }
  };

  for (int e = tid; e < BS * D / 4; e += 256) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    cp_async16(q_raw + r * LDR + c, q + q_off + static_cast<long long>(r) * D + c, true);
  }
  if (n_sub > 0) load_raw(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (n_sub > 0) {
    split_sub(0);
    fence_proxy_async();
    __syncthreads();
    if (n_sub > 1) load_raw(1);
    cp_async_commit();
  }

  float o[NO], op[NO], sacc[16];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = op[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sacc[i] = 0.0f;
  RowState rs;

  for (int t = 0; t < n_sub; ++t) {
    const uint32_t* k_big = split + (t & 1) * S::split_words;
    const uint32_t* k_small = k_big + S::kv_words;
    const uint32_t* v_big = k_small + S::kv_words;
    const uint32_t* v_small = v_big + S::kv_words;

    // S = Q K^T on the tensor cores, summed over all of D, H steps a group;
    // the next sub-tile is split while the first group runs
#pragma unroll
    for (int k0 = 0; k0 < D / 8; k0 += H) {
      q_frags(k0);
      fence_operand(sacc);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int off = (k0 + i) * 64;  // two core matrices along K: 256 bytes
        wgmma_tf32(sacc, qs[i], smem_desc(k_big + off, S::LBO, S::SBO_D), k0 + i > 0);
        wgmma_tf32(sacc, qb[i], smem_desc(k_small + off, S::LBO, S::SBO_D), 1);
        wgmma_tf32(sacc, qb[i], smem_desc(k_big + off, S::LBO, S::SBO_D), 1);
      }
      wgmma_commit();
      fence_q();
      if (k0 == 0 && t + 1 < n_sub) {
        cp_async_wait<0>();
        __syncthreads();  // the next sub-tile's raw rows have all landed
        split_sub((t + 1) & 1);
        fence_proxy_async();
      }
      wgmma_wait_all();
      fence_q();
      fence_operand(sacc);
    }

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i / 4][i % 4] = sacc[i];
    float alpha_a, alpha_b;
    softmax_step<false>(s, ids[t / SUB] * BS + (t % SUB) * KW, KW, seq, t4,
                        scale, softcap, rs, alpha_a, alpha_b);

    // P V: P's A fragments from the score accumulators (logical k t4 / t4 +
    // 4 of step j = kv columns 8 j + 2 t4 / + 1: s[j][0], [2] / [1], [3])
    uint32_t pb[4][4], ps[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_frag(s[j][0], pb[j][0], ps[j][0]);
      split_frag(s[j][2], pb[j][1], ps[j][1]);
      split_frag(s[j][1], pb[j][2], ps[j][2]);
      split_frag(s[j][3], pb[j][3], ps[j][3]);
    }
    fence_operand(op);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const int off = j * 64;
      wgmma_tf32(op, ps[j], smem_desc(v_big + off, S::LBO, S::SBO_KW), j > 0);
      wgmma_tf32(op, pb[j], smem_desc(v_small + off, S::LBO, S::SBO_KW), 1);
      wgmma_tf32(op, pb[j], smem_desc(v_big + off, S::LBO, S::SBO_KW), 1);
    }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_operand(pb[j]);
      fence_operand(ps[j]);
    }
    if (t + 1 < n_sub) {
      __syncthreads();  // the next sub-tile's split is whole; its raw rows are free
      if (t + 2 < n_sub) load_raw(t + 2);
      cp_async_commit();
    }
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_operand(pb[j]);
      fence_operand(ps[j]);
    }
    fence_operand(op);
    // carried into the IEEE sums every KW = 32 kv rows, after the rescale
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] = o[4 * j] * alpha_a + op[4 * j];
      o[4 * j + 1] = o[4 * j + 1] * alpha_a + op[4 * j + 1];
      o[4 * j + 2] = o[4 * j + 2] * alpha_b + op[4 * j + 2];
      o[4 * j + 3] = o[4 * j + 3] * alpha_b + op[4 * j + 3];
    }
  }
  cp_async_wait<0>();

  float inv_a, inv_b;
  row_inverses(rs, inv_a, inv_b);
  float* O = out + q_off + static_cast<long long>(row) * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    *reinterpret_cast<float2*>(O + 8 * j) = make_float2(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<float2*>(O + 8 * D + 8 * j) =
        make_float2(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <typename T, int BS, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_ids,
           const int* n_kv, void* out, int b, int h, int hkv, int nq,
           int nk_cap, int seq, float scale, float softcap,
           cudaStream_t stream, int device) {
  static std::atomic<int> smem_set[64];
  if constexpr (std::is_same<T, float>::value && BS == 128 && (D == 64 || D == 128)) {
    using W = WgShape<D>;
    static_assert(W::smem_bytes <= 232448, "above the 227 KiB a block may use");
    auto* kernel = block_attn_wgmma_kernel<D>;
    cudaError_t err = allow_smem(smem_set, kernel, W::smem_bytes, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(nq, h, b), W::threads, W::smem_bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kv_ids, n_kv, static_cast<float*>(out),
        h, hkv, nq, nk_cap, seq, scale, softcap);
  } else {
    using S = Shape<T, BS, D>;
    static_assert(S::smem_bytes <= 232448, "above the 227 KiB a block may use");
    auto* kernel = block_attn_kernel<T, BS, D>;
    cudaError_t err = allow_smem(smem_set, kernel, S::smem_bytes, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(nq * (BS / S::BM), h * S::n_split, b), S::threads,
             S::smem_bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        kv_ids, n_kv, static_cast<T*>(out), h, hkv, nq, nk_cap, seq, scale, softcap);
  }
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

// Launches one thread block per (BM rows of a q block, head and output half
// at d = 256, batch) on `stream`.  q and out
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
    return launch_t<bf16>(bs, d, q, k, v, kv_ids, n_kv, out, b, h, hkv, nq, nk_cap, seq, scale, softcap, s, device);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
