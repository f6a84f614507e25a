"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), the kernels' device names
and the roofline bound of one launch.

A share of a roofline is the bound over the measured device time: the bound
is the larger of the operations over the peak of the inputs' type and the
bytes over the memory rate, each input read once and each output written
once (copied from ``chip_smoke.py``'s ``bound`` and peaks).
"""
from __future__ import annotations

FP32_FLOPS = 67e12          # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12         # bfloat16 and float16 dense tensor cores
HBM_BYTES_S = 3.35e12

#: the device kernels of each of the port's kernels (their names in a
#: profiler trace hold one of these), as ``chip_smoke.py`` sums them
KERNEL_NAMES = {
    "K1": ("bsr_spgemm_",), "K2": ("spmm_tile_kernel", "spmm_gemv_kernel"),
    "K3": ("block_attn_",), "K4": ("flash_attn_",),
    "K4 backward": ("attn_bwd_",), "K5": ("moe_gemm_",),
    "K6": ("chunk_local_kernel", "state_scan_kernel", "inter_chunk_kernel"),
    "K6 backward": ("bwd_mma_prep_kernel", "bwd_mma_chunk_kernel",
                    "bwd_local_kernel", "bwd_scan_kernel", "bwd_inter_kernel",
                    "bwd_du_kernel"),
    "K5 backward": ("moe_bwd_dx_", "moe_bwd_dw_", "moe_bwd_tma_kernel<false>",
                    "moe_bwd_tma_kernel<true>")}

ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def peak(dtype: str) -> float:
    """The operations peak of a kernel whose inputs have ``dtype``."""
    return BF16_FLOPS if dtype in ("bfloat16", "float16") else FP32_FLOPS


def bound_s(flop: float, nbytes: float, flops_peak: float) -> float:
    """The least time of a launch: operations or bytes, whichever binds."""
    return max(flop / flops_peak, nbytes / HBM_BYTES_S)
