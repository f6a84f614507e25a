"""Records each launch of K5 (``moe_gemm``) while a traced span runs: the
bundles' shape, the widths, the dtype and the rows that hold a routed token
(a dead bundle slot is a row of zeros, and so is its product), which
``bench/roofline/k5.py`` turns into operations and bytes.  The kept rows
are counted on the device, with no read back to the host until the span
has closed.

It wraps ``_launch`` of ``repro_torch.kernels.moe_gemm``, looked up at call
time.  (K5's backward runs in no cell yet; ``bench/roofline/k5.py`` counts
it for the cell that will.)
"""
from __future__ import annotations

KERNEL = "K5"


def _kept(x):
    """The rows of x (nb, cap, d) that are not all zero, on x's device."""
    return (x != 0).any(dim=-1).sum()


def install(rec):
    from repro_torch.kernels import moe_gemm as mod
    launch = mod._launch

    def shapes(kind, x, w):
        nb, cap, d_in = x.shape
        return dict(kind=kind, nb=nb, cap=cap, d_in=d_in, d_out=w.shape[-1],
                    n_experts=w.shape[0], dtype=str(x.dtype).replace(
                        "torch.", ""), kept=_kept(x))

    def launch_probe(x, w, bundle_expert, be, out):
        if rec.active:
            rec.add(KERNEL, shapes("fwd", x, w))
        return launch(x, w, bundle_expert, be, out)

    mod._launch = launch_probe

    def uninstall():
        mod._launch = launch
    return uninstall
