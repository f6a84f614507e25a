"""Dynamic purity harness: the runtime proof of REAP001.

Port of ``repro.analysis.purity_check``.  For every non-router op in
``repro_torch.runtime.ops.list_ops()``, build the op's example problem
twice — identical sparsity pattern, perturbed values — drive
``prepare → fingerprint → inspect`` through the registered hooks,
serialize both plans through ``serializer_for``, and assert the
fingerprints match and the serialized payloads are **bit-identical**.
Any value leak into a plan (however the AST pass missed it) shows up
here as differing plan bytes.

Plans are built under a ``RuntimeConfig`` for ``device`` (``"cuda"`` by
default, as every entry point of the port; ``"cpu"`` on the host).
Without a card a CUDA request raises before any op is replayed.

Registered non-router ops without an entry in
``op_examples.builtin_examples`` are reported as coverage-gap failures,
never silently skipped.

Needs torch and numpy; the static checker never imports this.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..device import resolve_device
from ..runtime import ops as _ops
from ..runtime.api import RuntimeConfig
from .op_examples import builtin_examples


def _plan_payload(spec: "_ops.OpSpec", operands, cfg, kw: dict):
    """prepare → fingerprint → inspect → serialize, returning
    (fingerprint, flat payload dict)."""
    kw = dict(kw)
    if spec.prepare is not None:
        kw = spec.prepare(operands, cfg, **kw)
    fp = spec.fingerprint(operands, cfg, chunked=False, **kw)
    plan = spec.inspect(operands, cfg, fp, **kw)
    return fp, _ops.serializer_for(fp.op)(plan)


def _payload_diff(p0: dict, p1: dict) -> Optional[str]:
    """First bitwise difference between two serialized plans, else None."""
    if set(p0) != set(p1):
        extra = set(p0) ^ set(p1)
        return f"payload keys differ: {sorted(extra)}"
    for key in sorted(p0):
        v0, v1 = p0[key], p1[key]
        if isinstance(v0, np.ndarray) or isinstance(v1, np.ndarray):
            a0, a1 = np.asarray(v0), np.asarray(v1)
            if a0.dtype != a1.dtype or a0.shape != a1.shape \
                    or a0.tobytes() != a1.tobytes():
                return f"array {key!r} differs (value leaked into plan)"
        elif v0 != v1:
            return f"field {key!r} differs: {v0!r} != {v1!r}"
    return None


def check_op_purity(tag: str, n: int = 384, device: str = "cuda") -> Dict:
    """Replay one op with perturbed values; dict result.  Raises only for a
    device that cannot be used (CUDA without a card)."""
    resolve_device(device)
    spec = _ops.get_op(tag)
    if spec.route is not None:
        return dict(ok=True, detail="router (no plans of its own)")
    example = builtin_examples(n).get(tag)
    if example is None:
        return dict(ok=False, detail="no example problem registered "
                                     "(coverage gap in op_examples)")
    cfg = RuntimeConfig(n_chunks=1, overlap=False, device=device,
                        **example.runtime_kw)
    try:
        fp0, payload0 = _plan_payload(spec, example.operands(0), cfg,
                                      example.kw)
        fp1, payload1 = _plan_payload(spec, example.operands(1), cfg,
                                      example.kw)
    except Exception as exc:           # a crash is a failed check, not an
        return dict(ok=False, detail=f"hook raised: {exc!r}")  # abort
    if fp0 != fp1:
        return dict(ok=False,
                    detail="fingerprint moved with values (not "
                           "pattern-pure)")
    diff = _payload_diff(payload0, payload1)
    if diff is not None:
        return dict(ok=False, detail=diff)
    return dict(ok=True, detail="bit-identical plan under value "
                                "perturbation")


def run_purity_checks(tags: Optional[List[str]] = None, n: int = 384,
                      device: str = "cuda") -> Dict[str, Dict]:
    """Harness over every registered op (or ``tags``); {tag: result}."""
    resolve_device(device)
    out: Dict[str, Dict] = {}
    for tag in (tags if tags is not None else _ops.list_ops()):
        out[tag] = check_op_purity(tag, n=n, device=device)
    return out
