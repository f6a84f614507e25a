// K5's bfloat16 machinery on TMA and wgmma (sm_90a), shared by its forward
// (csrc/moe_gemm.cu) and its backward (csrc/moe_gemm_bwd.cu): the
// expert-grouped walk of the schedule buffer (Walk, item_at), mbarriers,
// TMA box loads, the 128-byte-swizzle shared-memory descriptor, wgmma in
// bfloat16 at n = 256 and 128, and the tensor maps (bf16_map, through the
// runtime's driver entry point: the libraries link no libcuda of their own).
// Built into each library that includes it, so everything here sits in an
// anonymous namespace.  Include after common.cuh.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encode is reached at run time
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

// The schedule K5's TMA kernels walk (its forward's two routes, its
// backward's dx), one int32 buffer on the card:
//   [0, nb)            bundle_expert
//   [nb, 2 nb)         order: the bundles sorted by expert (stably)
//   [2 nb, 2 nb+G+1)   group starts: group g (one expert) owns
//                      order[starts[g] .. starts[g + 1])
// Group g's n_g bundles give n_g * per slots (per: 64-row tiles of a bundle
// on the tile route, 1 on the decode route), cut into units of `span`
// consecutive slots.  A work item is (group, column tile, unit), the units
// innermost: every unit of one column tile of one expert's weights runs side
// by side on neighbouring SMs, so that tile crosses the memory bus about once
// per product, not once per bundle.  Persistent blocks take items t =
// blockIdx.x, + gridDim.x, ... in this order.
struct Walk {
  const int* be;
  const int* order;
  const int* starts;
  int n_groups, per, span, n_col;
  int g = 0;             // the cursor: group of the last item sought,
  long long first = 0;   // its first item,
  int units = 0;         // its units

  // moves the cursor to item t (t never decreases); false past the last
  __device__ bool seek(long long t) {
    while (g < n_groups) {
      units = ((starts[g + 1] - starts[g]) * per + span - 1) / span;
      if (t < first + static_cast<long long>(units) * n_col) return true;
      first += static_cast<long long>(units) * n_col;
      ++g;
    }
    return false;
  }
};

// One work item, up to kMaxSlots slots: its expert, column tile and each
// slot's bundle and row tile.
constexpr int kMaxSlots = 4;
struct Item {
  int expert, col, n_slots;
  int bundle[kMaxSlots], tile[kMaxSlots];
};

__device__ __forceinline__ Item item_at(const Walk& w, long long t) {
  Item it;
  const long long local = t - w.first;
  const int unit = static_cast<int>(local % w.units);
  it.col = static_cast<int>(local / w.units);
  const int base = w.starts[w.g];
  const int slots = (w.starts[w.g + 1] - base) * w.per;
  it.n_slots = min(w.span, slots - unit * w.span);
#pragma unroll
  for (int i = 0; i < kMaxSlots; ++i) {
    const int s = min(unit * w.span + i, slots - 1);
    it.bundle[i] = w.order[base + s / w.per];
    it.tile[i] = s % w.per;
  }
  it.expert = w.be[it.bundle[0]];
  return it;
}

// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the barrier's phase of parity `parity` has completed; a wait
// that outlasts 2^26 polls (seconds, where a slice takes microseconds) traps,
// so that a fault in the pipeline fails the launch rather than hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity);)
    if (++polls == (1u << 26)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// box (c0, c1, c2) of `map` into shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory descriptor of a tile that TMA wrote with the 128-byte
// swizzle: rows of 128 bytes in 8-row atoms of 1 KiB.  K-major (x as A, x as
// B): sbo = 1024 between the 8-row atoms along M (N), lbo unused.  MN-major
// (w's [k][n] boxes): lbo = 8192 between the 64-column boxes along N (M),
// sbo = 1024 between the 8-deep atoms along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma in bfloat16, fp32 accumulate: d = a * b + (scale_d ? d : 0), A (64
// x 16) and B (16 x N) from shared memory, TA / TB 1 where A / B lies
// MN-major (transposed), 0 where it lies K-major.  K5's forward takes the
// defaults: A (x) K-major, B (w's [k][n] boxes) MN-major.
template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t a_desc,
    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 1>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t a_desc,
    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TA), "n"(TB));
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point:
// the library links no libcuda of its own.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// TMA's L2 promotion of the boxes' reads: 256 bytes (scripts/card_studies.py
// k5-bf16 times a build without it beside the shipped one)
#ifdef REPRO_K5_NO_L2_PROMOTION
constexpr CUtensorMapL2promotion kL2Promotion = CU_TENSOR_MAP_L2_PROMOTION_NONE;
#else
constexpr CUtensorMapL2promotion kL2Promotion = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
#endif

// A failed encode returns kEncodeFailed + its CUresult, above CUDA's codes.
constexpr int kEncodeFailed = 1 << 20;

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The bfloat16 row-major (d2, d1, d0) tensor at p as a TMA map of (1, b1, b0)
// boxes with the 128-byte swizzle; what a box reads past an edge is zero.
int bf16_map(CUtensorMap* map, const void* p, uint64_t d0, uint64_t d1,
             uint64_t d2, uint32_t b0, uint32_t b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, kL2Promotion,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

int sm_count(int device, int* count) {
  static std::atomic<int> known[64];
  if (device < 64 && (*count = known[device].load(std::memory_order_acquire)))
    return 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64)
    known[device].store(*count, std::memory_order_release);
  return static_cast<int>(err);
}

}  // namespace
