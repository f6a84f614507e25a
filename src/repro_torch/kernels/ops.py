"""Public entry points of the port's hand-written kernels.

Each dispatches on its tensors' device: CPU tensors run the kernel's plain
PyTorch version, CUDA tensors launch the kernel or raise.  This replaces
the reference's ``interpret`` auto-detection (``repro.kernels.ops``).
"""
from __future__ import annotations

from .bsr_spgemm import bsr_spgemm, bsr_spgemm_schedule  # noqa: F401
from .bsr_spmm import bsr_spmm  # noqa: F401
from .flash_attention import (attention_block_schedule,  # noqa: F401
                              block_sparse_attention,
                              block_sparse_attention_plan, flash_attention)
from .moe_gemm import (moe_gemm, moe_gemm_bwd,  # noqa: F401
                       moe_gemm_bwd_plain, moe_gemm_schedule)
from .rwkv6_scan import rwkv6  # noqa: F401
