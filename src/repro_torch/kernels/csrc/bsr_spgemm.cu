// Block SpGEMM (kernel K1) for Hopper, sm_90a.
//
//   C[out_id[t]] += A[a_id[t]] @ B[b_id[t]]   over a schedule sorted by out_id
//
// Replaces the Pallas TPU kernel repro.kernels.bsr_spgemm.bsr_spgemm
// (src/repro/kernels/bsr_spgemm.py:41).  The TPU version walks one grid step
// per block pair and keeps the output tile in VMEM across its group; here a
// thread block owns whole output groups (runs of equal out_id, given by
// group_start), keeps the BS x BS fp32 accumulator in registers, and writes
// each tile once with no atomics.  Groups are independent, so the 132 SMs
// take them in any order.
//
// Bound: 2*BS^3 fp32 FLOP per pair on 2*BS^2*4 bytes of operands, so at
// BS = 128 (filter3D's block) it is bound by operations.  The reference holds
// K1 to 1e-5.  Two kernels, picked by BS:
//
//  * BS = 64 and 128 (the runtime's default block): one output group is one
//    GEMM of a BS x BS tile over a depth of BS * (pairs in the group), with A
//    and B tiles gathered by id.  The blocks are persistent (as many as fit
//    on the SMs at once), each taking a run of groups balanced by pairs: at
//    filter3D a group has 1.8 pairs on average, so a block per group spent
//    most of its time filling and draining its ring.  3xTF32 on the tensor cores, as K5 does
//    (moe_gemm.cu): each fp32 operand is split into big = tf32(x) and small =
//    tf32(x - big) and wgmma m64nBSk8 sums small*big + big*small + big*big,
//    one warpgroup per 64 rows.  The group's pairs are walked as 32-deep
//    slices (BS / 32 per pair); raw fp32 slices of A and B stream through a
//    2-stage cp.async ring, so the loads of slice i + 2 are in flight while
//    slice i is multiplied; each thread splits the chunks it copied itself
//    into big and small halves, once per block, in the 8 x 16-byte core
//    matrices the tensor cores read from shared memory.  TF32 takes B only
//    K-major, so B's [k][n] rows are transposed as they are split (each
//    thread rotating its 4 x 4 tile so that a warp's stores spread over all
//    banks).  One barrier per slice: slice i + 1 is split while the tensor
//    cores multiply slice i.  The tensor cores' own accumulation truncates,
//    so the products are summed from zero over kCarryDepth of k (32, one
//    slice) and carried into the IEEE fp32 accumulator with IEEE adds (and
//    at the end of each group).  REPRO_K1_CARRY (8, 16, 32, 64 or 128) sets
//    the depth; scripts/card_studies.py k1-carry builds the others into
//    libraries of their own to measure what the depth buys against the
//    1e-5 limit.
//  * BS = 16 and 32 (off the main path): IEEE fp32 FMAs, one block per
//    group.  256 threads as a 16 x 16 grid; thread (ty, tx) owns rows
//    ty + 16*i and columns tx + 16*j (i, j < TM = BS/16); each pair is
//    consumed in K panels of BK = BS with A stored transposed in shared
//    memory (padded by one word) and B as is.
//
// C entry point: plain C interface for ctypes; returns the first CUDA error
// of the attribute call or the launch (0 on success).

#include <cuda_runtime.h>

#include "common.cuh"

#ifndef REPRO_K1_CARRY
#define REPRO_K1_CARRY 32
#endif

namespace {

constexpr int kThreads = 256;  // the FMA kernel's block
constexpr int kCarryDepth = REPRO_K1_CARRY;
static_assert(kCarryDepth == 8 || kCarryDepth == 16 || kCarryDepth == 32 ||
                  kCarryDepth == 64 || kCarryDepth == 128,
              "REPRO_K1_CARRY is 8, 16, 32, 64 or 128");

// ---------------------------------------------------------------------------
// BS = 16 and 32: IEEE fp32 FMAs
// ---------------------------------------------------------------------------

template <int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const int* __restrict__ a_id, const int* __restrict__ b_id,
                  const int* __restrict__ out_id,
                  const int* __restrict__ group_start,
                  float* __restrict__ c) {
  constexpr int TM = BS / 16;
  constexpr int BK = BS < 32 ? BS : 32;
  constexpr int TILE = BS * BS;
  __shared__ __align__(16) float As[BK][BS + 1];
  __shared__ __align__(16) float Bs[BK][BS];

  const int g = blockIdx.x;
  const int p0 = group_start[g];
  const int p1 = group_start[g + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

  for (int p = p0; p < p1; ++p) {
    const float* A = a + static_cast<long long>(a_id[p]) * TILE;
    const float* B = b + static_cast<long long>(b_id[p]) * TILE;
    for (int k0 = 0; k0 < BS; k0 += BK) {
      // A panel: BS rows x BK columns, float4 along k, stored transposed.
      for (int v = tid; v < BS * BK / 4; v += kThreads) {
        const int m = v / (BK / 4);
        const int k = (v % (BK / 4)) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(A + m * BS + k0 + k);
        As[k + 0][m] = x.x;
        As[k + 1][m] = x.y;
        As[k + 2][m] = x.z;
        As[k + 3][m] = x.w;
      }
      // B panel: BK rows x BS columns, float4 along n.
      for (int v = tid; v < BK * BS / 4; v += kThreads) {
        const int k = v / (BS / 4);
        const int n = (v % (BS / 4)) * 4;
        *reinterpret_cast<float4*>(&Bs[k][n]) =
            *reinterpret_cast<const float4*>(B + (k0 + k) * BS + n);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float ar[TM], br[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ar[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TM; ++j) br[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* C = c + static_cast<long long>(out_id[p0]) * TILE;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) C[(ty + 16 * i) * BS + tx + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// BS = 64 and 128: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

// One warpgroup per 64 rows, BS columns, 32-deep slices.  Shared memory: two
// split buffers, each A big and small (BS x 32 TF32) and B big and small (BS
// x 32 TF32, transposed: wgmma takes TF32 only K-major), in 8 x 4 core
// matrices; then the raw ring.
template <int BS>
struct WgShape {
  static constexpr int WGS = BS / 64;
  static constexpr int BK = 32;
  static constexpr int threads = 128 * WGS;
  static constexpr int STAGES = 2;
  static constexpr int slices = BS / BK;                 // slices per pair
  static constexpr int NACC = BS / 2;                    // accumulators a thread
  static constexpr int LDA = BK + 4;                     // raw A row (floats)
  static constexpr int raw_floats = BS * LDA + BK * BS;
  static constexpr int half_words = BS * BK;             // one half of A or B
  static constexpr int split_words = 4 * half_words;
  static constexpr int smem_bytes = 2 * split_words * 4 + STAGES * raw_floats * 4;
  static constexpr uint32_t LBO = 128;                   // next 4 k
  static constexpr uint32_t SBO = BK / 4 * 128;          // next 8 rows
};

// A persistent block: it takes a run of whole groups, balanced by pairs
// (block c starts at the first group at or after pair c * n_pairs / grid),
// and walks their pairs as one stream of 32-deep slices, so the ring stays
// full across group boundaries; at the end of each group the accumulator is
// stored to the group's tile and cleared.
template <int BS>
__global__ void __launch_bounds__(WgShape<BS>::threads, BS == 64 ? 2 : 1)
bsr_spgemm_wgmma_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const int* __restrict__ a_id,
                        const int* __restrict__ b_id,
                        const int* __restrict__ out_id,
                        const int* __restrict__ group_start, int n_groups,
                        float* __restrict__ c) {
  using S = WgShape<BS>;
  constexpr int BK = S::BK, LDA = S::LDA, STAGES = S::STAGES, NACC = S::NACC;
  constexpr int NT = S::threads;
  constexpr int KSTEPS = BK / 8;                // 8-deep wgmma steps a slice
  // eight-deep steps a wait group (a carry follows each one up to a depth of
  // 32), and slices between carries above it; a group's end carries too
  constexpr int KG = kCarryDepth < BK ? kCarryDepth / 8 : KSTEPS;
  constexpr int SPC = kCarryDepth > BK ? kCarryDepth / BK : 1;
  constexpr int TILE = BS * BS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint32_t* split = reinterpret_cast<uint32_t*>(smem_raw);            // [2]
  float* raw = reinterpret_cast<float*>(split + 2 * S::split_words);  // [STAGES]

  // the first group whose first pair is at or after `pair`
  auto group_at = [&](long long pair) {
    int lo = 0, hi = n_groups;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (group_start[mid] < pair) lo = mid + 1;
      else hi = mid;
    }
    return lo;
  };
  const long long n_pairs = group_start[n_groups];
  int g = group_at(blockIdx.x * n_pairs / gridDim.x);
  const int g_end = group_at((blockIdx.x + 1) * n_pairs / gridDim.x);
  const int p0 = group_start[g];
  const int n_it = (group_start[g_end] - p0) * S::slices;
  if (n_it == 0) return;
  int next_group = group_start[g + 1];  // first pair past the current group
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // Each thread copies, and later splits, the same pieces of every slice:
  // A chunks e = tid + NT i (16 bytes: row r, k 4 kc..), placed so that the
  // 32 lanes of a warp cover 8 rows x 4 chunks; B tiles of 4 k x 4 n
  // (n4 = tau % (BS / 4), k quad kq = tau / (BS / 4)).
  auto a_chunk = [&](int e, int& r, int& kc) {
    const int g32 = e / 32;
    r = 8 * (g32 % (BS / 8)) + e % 8;
    kc = 4 * (g32 / (BS / 8)) + (e / 8) % 4;
  };
  auto load_slice = [&](int i) {
    float* as = raw + (i % STAGES) * S::raw_floats;
    float* bs = as + BS * LDA;
    const int p = p0 + i / S::slices;
    const int k0 = (i % S::slices) * BK;
    const float* A = a + static_cast<long long>(a_id[p]) * TILE + k0;
    const float* B = b + static_cast<long long>(b_id[p]) * TILE +
                     static_cast<long long>(k0) * BS;
#pragma unroll
    for (int e = tid; e < BS * BK / 4; e += NT) {
      int r, kc;
      a_chunk(e, r, kc);
      cp_async16(as + r * LDA + 4 * kc, A + r * BS + 4 * kc, true);
    }
#pragma unroll
    for (int tau = tid; tau < BK * BS / 16; tau += NT) {
      const int n = 4 * (tau % (BS / 4));
      const int kq = tau / (BS / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(bs + (4 * kq + j) * BS + n, B + (4 * kq + j) * BS + n, true);
    }
  };
  auto split_slice = [&](int i) {
    const float* as = raw + (i % STAGES) * S::raw_floats;
    const float* bs = as + BS * LDA;
    uint32_t* a_big = split + (i & 1) * S::split_words;
    uint32_t* a_small = a_big + S::half_words;
    uint32_t* b_big = a_small + S::half_words;
    uint32_t* b_small = b_big + S::half_words;
#pragma unroll
    for (int e = tid; e < BS * BK / 4; e += NT) {
      int r, kc;
      a_chunk(e, r, kc);
      const float4 v = *reinterpret_cast<const float4*>(as + r * LDA + 4 * kc);
      const uint2 q0 = split_tf32(v.x), q1 = split_tf32(v.y);
      const uint2 q2 = split_tf32(v.z), q3 = split_tf32(v.w);
      const int off = core_word<BK>(r, 4 * kc);
      *reinterpret_cast<uint4*>(a_big + off) = make_uint4(q0.x, q1.x, q2.x, q3.x);
      *reinterpret_cast<uint4*>(a_small + off) = make_uint4(q0.y, q1.y, q2.y, q3.y);
    }
#pragma unroll
    for (int tau = tid; tau < BK * BS / 16; tau += NT) {
      const int n4 = tau % (BS / 4);
      const int kq = tau / (BS / 4);
      // rotate by n4 / 2 so that the lanes of a warp store to all 8 rows of
      // a core matrix at each step
      const int rot = (n4 >> 1) & 3;
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = rotate4(*reinterpret_cast<const float4*>(bs + (4 * kq + j) * BS + 4 * n4), rot);
      const float* vf = reinterpret_cast<const float*>(v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = 4 * n4 + ((q + rot) & 3);
        const uint2 q0 = split_tf32(vf[q]), q1 = split_tf32(vf[4 + q]);
        const uint2 q2 = split_tf32(vf[8 + q]), q3 = split_tf32(vf[12 + q]);
        const int off = core_word<BK>(n, 4 * kq);
        *reinterpret_cast<uint4*>(b_big + off) = make_uint4(q0.x, q1.x, q2.x, q3.x);
        *reinterpret_cast<uint4*>(b_small + off) = make_uint4(q0.y, q1.y, q2.y, q3.y);
      }
    }
  };

  const int lane = tid % 32;
  const int r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;  // acc's row
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = part[i] = 0.0f;
  bool fresh = true;  // part holds no sum yet

#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n_it) load_slice(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // this thread's pieces of slice 0
  split_slice(0);
  if (STAGES < n_it) load_slice(STAGES);
  cp_async_commit();
  fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < n_it; ++i) {
    const uint32_t* a_big = split + (i & 1) * S::split_words + wg * 64 * BK;
    const uint32_t* a_small = a_big + S::half_words;
    const uint32_t* b_big = split + (i & 1) * S::split_words + 2 * S::half_words;
    const uint32_t* b_small = b_big + S::half_words;
    const int p = p0 + i / S::slices;
    const bool group_end = i % S::slices == S::slices - 1 && p + 1 == next_group;
#pragma unroll
    for (int g0 = 0; g0 < KSTEPS; g0 += KG) {
      // KG eight-deep steps, small terms first, summed from zero after a
      // carry
      fence_operand(part);
      wgmma_fence();
#pragma unroll
      for (int j = g0; j < g0 + KG; ++j) {
        const int off = j * 64;  // two core matrices along K: 256 bytes
        wgmma_tf32(part, smem_desc(a_small + off, S::LBO, S::SBO),
                   smem_desc(b_big + off, S::LBO, S::SBO), j > g0 || !fresh);
        wgmma_tf32(part, smem_desc(a_big + off, S::LBO, S::SBO),
                   smem_desc(b_small + off, S::LBO, S::SBO), 1);
        wgmma_tf32(part, smem_desc(a_big + off, S::LBO, S::SBO),
                   smem_desc(b_big + off, S::LBO, S::SBO), 1);
      }
      wgmma_commit();
      fence_operand(part);
      if (g0 + KG == KSTEPS) {
        // meanwhile: split slice i + 1 (its buffer's last readers, slice
        // i - 1's wgmmas, are done) and start the loads of slice
        // i + 1 + STAGES
        if (i + 1 < n_it) {
          cp_async_wait<STAGES - 1>();
          split_slice(i + 1);
          if (i + 1 + STAGES < n_it) load_slice(i + 1 + STAGES);
        }
        cp_async_commit();
      }
      wgmma_wait_all();
      fence_operand(part);
      fresh = SPC == 1 || (i + 1) % SPC == 0 || group_end;
      if (fresh) {
#pragma unroll
        for (int e = 0; e < NACC; ++e) acc[e] += part[e];
      }
    }
    if (group_end) {
      // the group's last slice: its tile out, the accumulator cleared.  acc:
      // warp ww of the warpgroup holds rows 16 ww + g (+ 8), columns
      // 8 j + 2 t4 (+ 1) in acc[4 j .. 4 j + 3]
      float* C = c + static_cast<long long>(out_id[p]) * TILE + r * BS;
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(C + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(C + 8 * BS + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.0f;
      }
      if (++g < n_groups) next_group = group_start[g + 1];
    }
    fence_proxy_async();
    __syncthreads();  // slice i + 1 is split; slice i's wgmmas are done
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int BS>
int launch_fma(const float* a, const float* b, const int* a_id,
               const int* b_id, const int* out_id, const int* group_start,
               int n_groups, float* c, cudaStream_t stream) {
  bsr_spgemm_kernel<BS><<<n_groups, kThreads, 0, stream>>>(
      a, b, a_id, b_id, out_id, group_start, c);
  return static_cast<int>(cudaGetLastError());
}

template <int BS>
int launch_wgmma(const float* a, const float* b, const int* a_id,
                 const int* b_id, const int* out_id, const int* group_start,
                 int n_groups, float* c, cudaStream_t stream, int device) {
  using S = WgShape<BS>;
  static_assert(S::smem_bytes <= 232448, "above the 227 KiB a block may use");
  auto* kernel = bsr_spgemm_wgmma_kernel<BS>;
  static std::atomic<int> smem_set[64];
  cudaError_t err = allow_smem(smem_set, kernel, S::smem_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = min(n_groups, sms * (BS == 64 ? 2 : 1));  // resident blocks
  kernel<<<grid, S::threads, S::smem_bytes, stream>>>(
      a, b, a_id, b_id, out_id, group_start, n_groups, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one thread block per output group on `stream`.  The caller has
// checked dtypes, shapes, 16-byte alignment and index ranges, zeroed `c`, and
// passes n_groups >= 1.  Returns the first CUDA error of the attribute call
// or the launch.
int bsr_spgemm_f32(const float* a, const float* b, const int* a_id,
                   const int* b_id, const int* out_id, const int* group_start,
                   int n_groups, int bs, float* c, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: return launch_fma<16>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s);
    case 32: return launch_fma<32>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s);
    case 64: return launch_wgmma<64>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s, device);
    case 128: return launch_wgmma<128>(a, b, a_id, b_id, out_id, group_start, n_groups, c, s, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
