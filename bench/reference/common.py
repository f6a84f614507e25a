"""What the plain references share: float32 with TF32 off, the RMSNorm, and
the rounding of a lower precision for the controls.

A reference computes in float32 (``"f32"``).  Its control computes the same
function with every product's operands rounded to the precision below the
one the configuration states for its compute (``"fp8"``: float8 e4m3 with
one scale a tensor, its largest magnitude at 448, as fp8 training scales
it; ``"bf16"`` is the program's own compute precision, for comparison).
The rounding is a straight-through one: the backward of a rounded operand
is the identity, and the backward products meet the rounded values.
Imports nothing of the program.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def float32_only() -> None:
    """Products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class Rounding:
    """``q(x)``: x rounded to the precision named, in x's dtype, with the
    identity as its backward."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        with torch.no_grad():
            low = _fp8(x) if self.mode == "fp8" else \
                x.to(torch.bfloat16).to(x.dtype)
        if not x.requires_grad:
            return low
        return x + (low - x).detach()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def mm(q: Rounding, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands rounded by ``q``."""
    return q(x) @ q(w)
