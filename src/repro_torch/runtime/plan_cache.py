"""Plan cache: amortize REAP's one-time CPU pass across same-pattern calls.

Port of ``repro.runtime.plan_cache``.  Payloads key only on registered type
names, so ``serialize_plan`` here writes bytes equal to the reference's and
``deserialize_plan`` reads the reference's payloads (and the reverse).

The paper's inspector cost is paid once per sparsity pattern; iterative
solvers, MoE dispatch, and the Fig-10 Cholesky sweep then reuse the plan for
every same-pattern-different-values operation (SMASH amortizes its
compression/indexing setup the same way).  This module provides:

  * ``PlanCache``     — thread-safe LRU keyed by ``PatternFingerprint``
                        (shape, nnz, indptr/indices digest, capacity/block
                        params).  A hit returns the exact plan object built
                        on the miss, so schedule bundles are bit-identical.
  * ``serialize_plan`` / ``deserialize_plan`` — plans ⇄ flat dict of numpy
    arrays (npz-compatible), so warm plans survive process restarts.

The serializer walks the *op registry's* type table (``runtime.ops``):
every plan dataclass an ``OpSpec`` declares in ``plan_types`` round-trips
through here with no edits to this module — that is how a newly registered
op (e.g. ``spmm``) becomes persistable for free.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import ops as _ops


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    store_hits: int = 0      # misses answered by the persistent store
    rejected: int = 0        # puts refused by the max_entry_bytes guard

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.store_hits + self.misses
        return (self.hits + self.store_hits) / total if total else 0.0


def _entry_nbytes(obj) -> int:
    """Cheap size estimate of a cached entry (arrays dominate real plans)."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_entry_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(_entry_nbytes(x) for x in obj)
    if isinstance(obj, dict):           # dict-shaped custom plans
        return sum(_entry_nbytes(k) + _entry_nbytes(v)
                   for k, v in obj.items())
    return sys.getsizeof(obj)


class PlanCache:
    """LRU cache of inspector plans keyed by pattern fingerprint.

    ``capacity`` counts entries (plans for production patterns are a few
    hundred MB at most; an entry count keeps the policy simple and
    predictable for tests).  ``capacity <= 0`` disables caching entirely —
    every lookup is a miss and nothing is stored.

    ``max_entry_bytes`` optionally rejects oversized entries at ``put``
    (counted in ``stats.rejected``).  The runtime's route-decision cache
    uses this: it is sized for tiny per-pattern strings, and the guard
    keeps an accidental plan-sized object from silently squatting there.

    ``store`` optionally attaches a persistent ``plan_store.PlanStore``:
    an in-memory miss falls back to disk (counted as ``stats.store_hits``)
    and every ``put`` write-through-persists, so same-pattern work survives
    process restarts.  The store is never consulted when caching is
    disabled (``capacity <= 0``).
    """

    def __init__(self, capacity: int = 64, store=None,
                 max_entry_bytes: Optional[int] = None):
        self.capacity = capacity
        self.store = store
        self.max_entry_bytes = max_entry_bytes
        self.stats = CacheStats()
        # optional hook fired by clear() — the runtime resets its per-op
        # counters through it so every stats view resets together
        self.on_clear: Optional[Callable[[], None]] = None
        self._entries: "OrderedDict[object, object]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fp) -> bool:
        with self._lock:
            return fp in self._entries

    def _insert_locked(self, fp, plan) -> None:
        self._entries[fp] = plan
        self._entries.move_to_end(fp)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def get_with_source(self, fp) -> Tuple[object, Optional[str]]:
        """Lookup returning ``(plan, source)``; source is ``"memory"``,
        ``"store"`` or ``None`` (miss) — the per-op stats the runtime
        reports key off this."""
        with self._lock:
            if fp in self._entries:
                self._entries.move_to_end(fp)
                self.stats.hits += 1
                return self._entries[fp], "memory"
        if self.store is not None and self.capacity > 0:
            plan = self.store.get(fp)       # disk IO outside the cache lock
            if plan is not None:
                with self._lock:
                    self.stats.store_hits += 1
                    self._insert_locked(fp, plan)
                return plan, "store"
        with self._lock:
            self.stats.misses += 1
        return None, None

    def get(self, fp):
        return self.get_with_source(fp)[0]

    def put(self, fp, plan) -> None:
        if self.capacity <= 0:
            return
        if self.max_entry_bytes is not None and \
                _entry_nbytes(plan) > self.max_entry_bytes:
            with self._lock:
                self.stats.rejected += 1
            return
        with self._lock:
            self._insert_locked(fp, plan)
        if self.store is not None:
            # best-effort write-through; PlanStore.put swallows IO errors
            # internally (stats.errors) so computation never fails on disk
            self.store.put(fp, plan)

    def get_or_build(self, fp, builder: Callable[[], object]):
        """Return (plan, hit).  ``builder`` runs outside the lock on a miss."""
        plan = self.get(fp)
        if plan is not None:
            return plan, True
        plan = builder()
        self.put(fp, plan)
        return plan, False

    def clear(self) -> None:
        """Drop every entry and reset the counters (``store_hits``
        included) — a cleared cache reports like a fresh one."""
        with self._lock:
            self._entries.clear()
            self.stats = CacheStats()
        if self.on_clear is not None:
            self.on_clear()


# ---------------------------------------------------------------------------
# Serialization: plan dataclasses ⇄ flat {key: ndarray} dicts
# ---------------------------------------------------------------------------
#
# The type table lives in the op registry (runtime.ops): each OpSpec's
# plan_types (and runtime.pipeline's chunk-set registrations) populate it,
# so this serializer never needs editing to support a new op.


def _flatten(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[prefix + "__type"] = np.str_(_ops.plan_type_name(type(obj)))
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if v is None or f.name == "fingerprint":
            continue                      # fingerprints are rebuilt by callers
        if isinstance(v, np.ndarray):
            out[key] = v
        elif isinstance(v, (int, float)):
            out[key] = np.asarray(v)
        elif isinstance(v, list):
            # lists hold either leaf arrays (CholeskyPlan levels) or nested
            # plan dataclasses (chunk sets); items may mix, keyed per index
            out[key + "__len"] = np.asarray(len(v))
            for i, item in enumerate(v):
                if dataclasses.is_dataclass(item):
                    _flatten(item, f"{key}__{i}::", out)
                elif item is None:
                    raise TypeError(
                        f"unserializable None in list field {f.name}[{i}] "
                        "(unmaterialized lazy chunk?)")
                else:
                    out[f"{key}__{i}"] = np.asarray(item)
        elif dataclasses.is_dataclass(v):
            _flatten(v, key + "::", out)
        else:
            raise TypeError(f"unserializable field {f.name}: {type(v)}")


def _unflatten(data: Dict[str, np.ndarray], prefix: str):
    cls = _ops.plan_type(str(data[prefix + "__type"]))
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name == "fingerprint":
            kwargs[f.name] = None
            continue
        key = f"{prefix}{f.name}"
        if key in data:
            v = data[key]
            if v.ndim == 0:
                v = v.item()
            kwargs[f.name] = v
        elif key + "__len" in data:
            n = int(data[key + "__len"])
            items = []
            for i in range(n):
                if f"{key}__{i}::__type" in data:
                    items.append(_unflatten(data, f"{key}__{i}::"))
                else:
                    items.append(np.asarray(data[f"{key}__{i}"]))
            kwargs[f.name] = items
        elif key + "::__type" in data:
            kwargs[f.name] = _unflatten(data, key + "::")
        else:
            raise KeyError(f"missing serialized field {key}")
    return cls(**kwargs)


def serialize_plan(plan) -> Dict[str, np.ndarray]:
    """Plan → flat dict of numpy arrays (pass to ``np.savez`` to persist).

    Plans that build parts of themselves lazily (chunk sets) expose a
    ``materialize()`` method; it is invoked first so every nested field is
    concrete.
    """
    materialize = getattr(plan, "materialize", None)
    if callable(materialize):
        materialize()
    out: Dict[str, np.ndarray] = {}
    _flatten(plan, "", out)
    return out


def deserialize_plan(data: Dict[str, np.ndarray]):
    """Inverse of ``serialize_plan`` (also accepts an ``np.load`` result)."""
    return _unflatten(dict(data), "")
