"""Records each launch of K6 (``rwkv6_scan``) and of its backward
(``rwkv6_scan_bwd``) while a traced span runs: the launch's shapes and
dtypes, which ``bench/roofline/k6.py`` turns into operations and bytes.

It wraps the two functions of ``repro_torch.kernels.rwkv6_scan`` that issue
the launches (``_launch`` for the forward, ``_k6_bwd`` for the backward);
both are looked up at call time, so the wrapper sees every launch.
"""
from __future__ import annotations

KERNEL = "K6"


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def install(rec):
    from repro_torch.kernels import rwkv6_scan as mod
    launch, bwd = mod._launch, mod._k6_bwd

    def shapes(kind, r, v, w, chunk):
        b, h, t, kk = r.shape
        return dict(kind=kind, b=b, h=h, t=t, kk=kk, vv=v.shape[-1],
                    chunk=chunk, r_dtype=_dtype(r), w_dtype=_dtype(w))

    def launch_probe(r, k, v, w, u, o, state, chunk):
        if rec.active:
            rec.add(KERNEL, shapes("fwd", r, v, w, chunk))
        return launch(r, k, v, w, u, o, state, chunk)

    def bwd_probe(r, k, v, w, u, do, dstate, chunk, **kw):
        if rec.active:
            rec.add(KERNEL, dict(shapes("bwd", r, v, w, chunk),
                                 dstate=dstate is not None))
        return bwd(r, k, v, w, u, do, dstate, chunk, **kw)

    mod._launch, mod._k6_bwd = launch_probe, bwd_probe

    def uninstall():
        mod._launch, mod._k6_bwd = launch, bwd
    return uninstall
