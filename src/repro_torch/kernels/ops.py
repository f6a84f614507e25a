"""Public entry points of the port's hand-written kernels.

Each dispatches on its tensors' device: CPU tensors run the kernel's plain
PyTorch version, CUDA tensors launch the kernel or raise.  This replaces
the reference's ``interpret`` auto-detection (``repro.kernels.ops``).
"""
from __future__ import annotations

from .bsr_spgemm import bsr_spgemm, bsr_spgemm_schedule  # noqa: F401
