"""Device selection and host→device copies for the port's executors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
CUDA request on a machine without a card raises: nothing carries on
quietly on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``"cuda"`` / ``"cpu"`` / ``torch.device`` → ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device``.

    On CUDA the copy goes on the current stream with ``non_blocking=True``;
    the driver stages pageable memory before the call returns, so the host
    array may be freed at once.  On the CPU the tensor shares the array's
    memory.
    """
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device, non_blocking=True)
