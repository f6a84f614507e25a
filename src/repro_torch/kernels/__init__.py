"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``), each
beside its plain PyTorch version; ``ops`` is the public surface.  K5's
backward entry points are also exported here."""
from .moe_gemm import moe_gemm_bwd, moe_gemm_bwd_plain  # noqa: F401
