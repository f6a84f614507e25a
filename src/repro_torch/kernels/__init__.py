"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``), each
beside its plain PyTorch version; ``ops`` is the public surface."""
