"""PyTorch/CUDA port of the REAP system (``repro``), slice by slice.

``core`` holds the host inspector (numpy) and the device executors (torch),
``kernels`` the hand-written Hopper kernels with their plain versions, and
``runtime`` the plan-cached, overlapped ``ReapRuntime``.  Nothing here
imports JAX or the ``repro`` package; the parity tests hold each module
against its ``repro`` counterpart.
"""
