"""Registered planned-op protocol: one contract for every sparse kernel.

Port of ``repro.runtime.ops`` with its own registry: the reference's
``_ensure_builtin_ops`` imports the JAX modules, so the port keeps a copy
whose built-ins are the port's own ops.

REAP's claim is that *every* sparse computation factors into the same
stages — pattern inspection on the CPU, an RIR hand-off, pipelined
execution.  This module turns that factoring into a protocol instead of a
per-op convention: an :class:`OpSpec` describes how one operation
fingerprints its pattern, builds a plan, and executes it, and a
process-wide registry lets every generic layer (`ReapRuntime.run`, the
plan cache's serializer, the persistent store, `serve.py`, benchmarks)
enumerate ops instead of hard-coding tag lists.

Admitting a new op to the whole stack — plan cache, overlap pipeline,
serialization — is one :func:`register_op` call next to the kernel (see
docs/architecture.md "Op registry").

This module deliberately imports nothing from the rest of the package so
the `core/` modules that host the built-in registrations can import it
without cycles; the built-in ops are pulled in lazily the first time the
registry is consulted (:func:`_ensure_builtin_ops`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "OpSpec", "OpCapabilities", "capability_summary",
    "register_op", "unregister_op", "get_op", "list_ops",
    "register_plan_type", "plan_type", "plan_type_name",
    "serializer_for", "deserializer_for",
    "REQUIRED_HOOKS", "ROUTER_HOOK", "EXECUTOR_HOOKS", "INSPECTOR_HOOKS",
    "SERIALIZER_HOOKS", "VALUE_ATTRS", "PATTERN_ATTRS",
    "CAPABILITY_ROUTINGS",
]

# -- Machine-readable contract metadata ---------------------------------------
# One description of the OpSpec contract, consumed by the runtime
# (``OpSpec.__post_init__``); copied verbatim from the reference so both
# packages enforce the same contract.  ops.py imports nothing beyond the
# stdlib.
REQUIRED_HOOKS: Tuple[str, ...] = ("fingerprint", "inspect", "execute_sync")
ROUTER_HOOK: str = "route"
EXECUTOR_HOOKS: Tuple[str, ...] = ("execute_sync", "execute_chunked",
                                   "shard_plan")
INSPECTOR_HOOKS: Tuple[str, ...] = ("fingerprint", "inspect", "prepare")
SERIALIZER_HOOKS: Tuple[str, ...] = ("serialize", "deserialize")
# operand attributes that carry *values* — off-limits to inspector hooks —
# vs. the pattern attributes plans may be built from (REAP001)
VALUE_ATTRS: Tuple[str, ...] = ("data", "values")
PATTERN_ATTRS: Tuple[str, ...] = (
    "indptr", "indices", "shape", "dtype", "n_rows", "n_cols", "nnz")
# where an op's dispatch decision runs: "host" = the inspector plans on
# the host and the executor is launched from host code (the common REAP
# shape); "in_graph" = the op also ships a traced/jitted routing variant
# that lives inside a compiled graph (e.g. moe_dispatch's in-graph twin)
CAPABILITY_ROUTINGS: Tuple[str, ...] = ("host", "in_graph")
# the declared fields of ``api.RunStats`` — the only keys the runtime may
# set on a run's stats record.  REAP002 enforces this machine-readably:
# ad-hoc ``stats["new_key"] = ...`` writes in protected runtime modules
# are violations until the key is declared here (and as a RunStats field),
# so the typed stats surface and the linted one cannot drift apart.
RUNSTATS_FIELDS: Tuple[str, ...] = (
    "cache_hit", "store_hit", "exec_cache_hit", "fingerprint", "inspect_s")


@dataclasses.dataclass(frozen=True)
class OpCapabilities:
    """Declarative per-op capability metadata (pure data, no behavior).

    Enumeration layers — ``serve.py``'s registry report, the benchmark
    per-op rows, the conformance suite — consume this via
    :func:`capability_summary` so they can annotate and scope per-op
    checks without hard-coding tag lists.

    ``dtypes``
        Value dtype names the executors accept for operand *values*
        (plans are value-free, so this never enters a fingerprint).

    ``routing``
        One of :data:`CAPABILITY_ROUTINGS` — whether dispatch decisions
        run on the host only or the op also has an in-graph variant.

    ``shardable``
        The op can execute across a device mesh through its
        ``shard_plan`` hook (``ReapRuntime.run(..., mesh=...)`` consults
        this).  ``OpSpec.__post_init__`` enforces that the declaration
        and the hook agree, so the flag cannot drift from the hook
        actually registered.

    Chunked-executor availability is deliberately *derived*, never
    declared: ``spec.execute_chunked is not None`` is the ground truth
    and :func:`capability_summary` reports it, so the metadata cannot
    drift from the hooks actually registered.
    """

    dtypes: Tuple[str, ...] = ("float32",)
    routing: str = "host"
    shardable: bool = False

    def __post_init__(self):
        if self.routing not in CAPABILITY_ROUTINGS:
            raise ValueError(
                f"unknown routing {self.routing!r}; expected one of "
                f"{CAPABILITY_ROUTINGS}")
        if not self.dtypes:
            raise ValueError("capabilities must declare at least one dtype")


def capability_summary(spec: "OpSpec") -> Dict[str, object]:
    """Flat capability dict for one spec (the reporting contract).

    ``{"dtypes": (...), "routing": "host"|"in_graph", "chunked": bool,
    "shardable": bool}``; routers report their own declared metadata with
    ``chunked=False``.
    """
    cap = spec.capabilities
    return dict(dtypes=tuple(cap.dtypes), routing=cap.routing,
                chunked=spec.execute_chunked is not None,
                shardable=cap.shardable)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Contract of one planned sparse operation.

    Every hook receives the positional ``operands`` tuple exactly as passed
    to ``ReapRuntime.run(tag, *operands, **kw)``, the runtime's
    ``RuntimeConfig`` as ``cfg``, and the call's remaining keyword
    arguments.  Hooks:

    ``fingerprint(operands, cfg, *, chunked, **kw)``
        Stage-1 inspection: digest the operand *patterns* (never values)
        plus every plan-shaping parameter into a ``PatternFingerprint``.
        ``chunked`` tells the spec whether the chunked executor will run,
        so it can key chunked plans separately (chunk count shapes them).

    ``inspect(operands, cfg, fp, **kw)``
        Stage-2 plan-build on a cache miss: a *pure* plan (pattern-derived
        index arrays only — the purity is what makes plans cacheable and
        persistable).  ``fp`` is the fingerprint to stamp on the plan.

    ``execute_sync(plan, operands, cfg, *, overlap, **kw)``
        Stage-3+4 for the synchronous path: bundle-emit + execute.
        Returns ``(result, stats)``; ``result`` is op-defined (may be a
        tuple), ``stats`` a flat dict.  The dispatcher adds ``cache_hit``,
        ``inspect_s`` and ``fingerprint`` afterwards.

    ``execute_chunked(cached, operands, cfg, *, overlap, **kw)`` (optional)
        Overlapped path, used when the runtime's ``n_chunks > 1``.
        ``cached`` is the warm plan artifact or ``None``; returns
        ``(result, stats, artifact)`` where ``artifact`` is admitted to the
        cache on a cold call (chunked executors build their chunk sets
        lazily *inside* the pipeline so cold inspection overlaps device
        execution — that is why build is not forced through ``inspect``).

    ``shard_plan(cached, operands, cfg, *, mesh, **kw)`` (optional)
        Sharded path, used when ``ReapRuntime.run`` receives a ``mesh``
        (or the runtime's ``mesh_shape`` is set) and ``capabilities``
        declares ``shardable=True``.  Mirrors ``execute_chunked``:
        ``cached`` is the warm shard artifact or ``None``; returns
        ``(result, stats, artifact)``.  The hook owns the partitioning
        (``runtime/shard.py`` hosts the built-in implementations) and
        must produce results bit-for-bit identical to the single-host
        path — the conformance suite asserts exact equality.

    ``route(operands, cfg, routes_cache, **kw)`` (optional)
        Pure dispatch hook: return ``(concrete_tag, new_kw)``.  A spec
        with ``route`` set is an alias/router (e.g. ``spgemm`` →
        ``spgemm_gather``/``spgemm_block``); it needs no other hooks.
        ``routes_cache`` is the runtime's small decision cache so routing
        heuristics are paid once per pattern.

    ``prepare(operands, cfg, **kw)`` (optional)
        Return an enriched ``kw`` dict, called once per dispatch before
        ``fingerprint``.  Use it to compute derived values both
        ``fingerprint`` and ``inspect`` need (e.g. ``moe_dispatch``'s
        routing CSR and resolved capacity) so a cache miss doesn't pay
        them twice.

    ``serialize(plan)`` / ``deserialize(flat_dict)`` (optional)
        Persistence hooks consulted by the plan store via
        :func:`serializer_for`; default to the generic
        ``plan_cache.serialize_plan`` / ``deserialize_plan``.

    ``plan_types``
        ``{type_name: dataclass}`` serialization table entries this op
        contributes (merged into the process-wide table the generic
        serializer walks).

    ``fingerprint_ops``
        The fingerprint ``op`` strings this spec owns (defaults to
        ``(tag,)``); the store resolves persistence hooks through them.

    ``allowed_kw``
        Keyword arguments ``run(tag, ...)`` accepts for this op.  When
        declared, unknown kwargs raise ``TypeError`` (the strictness the
        per-op methods had before the registry — a typo'd ``dtyp=`` must
        not silently fall into a ``**kw`` sink).  ``None`` (default)
        skips validation, for user ops with open-ended hooks.

    ``capabilities``
        :class:`OpCapabilities` metadata (supported value dtypes,
        host-vs-in-graph routing).  Pure annotation: the dispatcher never
        branches on it; reporting layers read it via
        :func:`capability_summary`.
    """

    tag: str
    fingerprint: Optional[Callable] = None
    inspect: Optional[Callable] = None
    execute_sync: Optional[Callable] = None
    execute_chunked: Optional[Callable] = None
    shard_plan: Optional[Callable] = None
    route: Optional[Callable] = None
    prepare: Optional[Callable] = None
    serialize: Optional[Callable] = None
    deserialize: Optional[Callable] = None
    plan_types: Mapping[str, type] = dataclasses.field(default_factory=dict)
    fingerprint_ops: Tuple[str, ...] = ()
    allowed_kw: Optional[Tuple[str, ...]] = None
    capabilities: OpCapabilities = dataclasses.field(
        default_factory=OpCapabilities)

    def __post_init__(self):
        if getattr(self, ROUTER_HOOK) is None:
            missing = [h for h in REQUIRED_HOOKS
                       if getattr(self, h) is None]
            if missing:
                raise ValueError(
                    f"op {self.tag!r} must define "
                    f"{'+'.join(REQUIRED_HOOKS)} (missing: "
                    f"{', '.join(missing)}), or be a pure router "
                    f"({ROUTER_HOOK}=...)")
        if (self.shard_plan is not None) != self.capabilities.shardable:
            raise ValueError(
                f"op {self.tag!r}: shard_plan hook and "
                f"capabilities.shardable must agree (hook "
                f"{'set' if self.shard_plan is not None else 'missing'}, "
                f"shardable={self.capabilities.shardable})")
        if not self.fingerprint_ops:
            object.__setattr__(self, "fingerprint_ops", (self.tag,))


_LOCK = threading.Lock()
_REGISTRY: Dict[str, OpSpec] = {}
_BY_FINGERPRINT_OP: Dict[str, OpSpec] = {}
_PLAN_TYPES: Dict[str, type] = {}
_TYPE_NAMES: Dict[type, str] = {}
_BUILTINS_LOADED = False
_BUILTINS_LOCK = threading.RLock()


def _ensure_builtin_ops() -> None:
    """Import the modules hosting the built-in registrations (lazy, once).

    Registrations live next to their executors (`core/inspector.py` for
    `moe_dispatch`, `core/spgemm.py`,
    `core/cholesky.py`, `runtime/pipeline.py` for the chunk-set plan
    types, `kernels/bsr_spmm.py`, `kernels/flash_attention.py`,
    `core/solver.py`); importing any of
    them registers their ops as a side effect, and this hook makes the
    registry complete regardless of which module the process touched
    first.  Concurrent consumers block on the (re-entrant) lock until the
    loading thread finishes, so none observes a partial registry; a
    failed import propagates but leaves the loaded flag unset, so the
    next consult retries instead of serving a permanently partial
    registry.
    """
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    with _BUILTINS_LOCK:
        if _BUILTINS_LOADED:
            return
        import repro_torch.core.inspector    # noqa: F401  moe_dispatch
        import repro_torch.core.spgemm       # noqa: F401  spgemm{,_gather,_block}
        import repro_torch.core.cholesky     # noqa: F401  cholesky
        import repro_torch.runtime.pipeline  # noqa: F401  chunk-set plan types
        import repro_torch.kernels.bsr_spmm  # noqa: F401  spmm
        import repro_torch.kernels.flash_attention  # noqa: F401  block_attention
        import repro_torch.core.solver       # noqa: F401  spmv
        _BUILTINS_LOADED = True


def register_plan_type(name: str, cls: type) -> None:
    """Add a dataclass to the generic serializer's type table.

    Idempotent for the same (name, cls) pair; a name collision with a
    *different* class is an error — persisted payloads key on these names.
    """
    with _LOCK:
        existing = _PLAN_TYPES.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"plan type name {name!r} already registered "
                             f"for {existing.__name__}")
        _PLAN_TYPES[name] = cls
        _TYPE_NAMES[cls] = name


def plan_type(name: str) -> type:
    """Type-table lookup for deserialization (loads built-ins on demand)."""
    _ensure_builtin_ops()
    try:
        return _PLAN_TYPES[name]
    except KeyError:
        raise KeyError(
            f"unknown plan type {name!r}; registered: "
            f"{sorted(_PLAN_TYPES)} — register the op (register_op) or the "
            "type (register_plan_type) before deserializing") from None


def plan_type_name(cls: type) -> str:
    """Inverse of :func:`plan_type`, for serialization."""
    _ensure_builtin_ops()
    try:
        return _TYPE_NAMES[cls]
    except KeyError:
        raise TypeError(
            f"{cls.__name__} is not a registered plan type; declare it in "
            "an OpSpec's plan_types (or register_plan_type) so it can be "
            "serialized") from None


def register_op(spec: OpSpec, *, allow_override: bool = False) -> OpSpec:
    """Admit an op to the registry (and its plan types to the serializer).

    Raises on a duplicate tag unless ``allow_override=True`` — silently
    shadowing an op would corrupt fingerprint→plan expectations of live
    caches/stores.
    """
    with _LOCK:
        # validate EVERYTHING before mutating: a failed registration must
        # leave no half-registered op behind
        if spec.tag in _REGISTRY and not allow_override:
            raise ValueError(f"op tag {spec.tag!r} already registered "
                             f"(pass allow_override=True to replace)")
        for fop in spec.fingerprint_ops:
            owner = _BY_FINGERPRINT_OP.get(fop)
            if owner is not None and owner.tag != spec.tag \
                    and not allow_override:
                raise ValueError(f"fingerprint op {fop!r} already owned by "
                                 f"op {owner.tag!r}")
        for name, cls in spec.plan_types.items():
            existing = _PLAN_TYPES.get(name)
            if existing is not None and existing is not cls:
                raise ValueError(f"plan type name {name!r} already "
                                 f"registered for {existing.__name__}")
        old = _REGISTRY.get(spec.tag)
        if old is not None:
            # overriding: purge the old spec's fingerprint-op claims so
            # strings the replacement no longer declares don't resolve to
            # the dead spec's hooks
            for fop in old.fingerprint_ops:
                if _BY_FINGERPRINT_OP.get(fop) is old:
                    del _BY_FINGERPRINT_OP[fop]
        _REGISTRY[spec.tag] = spec
        for fop in spec.fingerprint_ops:
            _BY_FINGERPRINT_OP[fop] = spec
        for name, cls in spec.plan_types.items():
            _PLAN_TYPES[name] = cls
            _TYPE_NAMES[cls] = name
    return spec


def unregister_op(tag: str) -> None:
    """Remove an op (tests/tooling; plan types stay registered)."""
    with _LOCK:
        spec = _REGISTRY.pop(tag, None)
        if spec is not None:
            for fop in spec.fingerprint_ops:
                if _BY_FINGERPRINT_OP.get(fop) is spec:
                    del _BY_FINGERPRINT_OP[fop]


def get_op(tag: str) -> OpSpec:
    """Resolve a registry tag; unknown tags fail with the known-op list."""
    _ensure_builtin_ops()
    try:
        return _REGISTRY[tag]
    except KeyError:
        raise KeyError(f"unknown op tag {tag!r}; registered ops: "
                       f"{list_ops()}") from None


def list_ops() -> List[str]:
    """Sorted tags of every registered op (built-ins loaded on demand)."""
    _ensure_builtin_ops()
    with _LOCK:
        return sorted(_REGISTRY)


def _spec_for_fingerprint_op(fp_op: str) -> Optional[OpSpec]:
    _ensure_builtin_ops()
    return _BY_FINGERPRINT_OP.get(fp_op)


def op_tag_for_fingerprint(fp_op: str) -> Optional[str]:
    """Registry tag owning a fingerprint's ``op`` string (None if unowned).

    E.g. ``"spgemm_gather_chunked"`` → ``"spgemm_gather"`` — the mapping
    reporting layers (serve's store report) use to attribute persisted
    plans to registered ops.
    """
    spec = _spec_for_fingerprint_op(fp_op)
    return spec.tag if spec is not None else None


def serializer_for(fp_op: str) -> Callable:
    """Plan → flat dict hook for a fingerprint op (generic by default)."""
    spec = _spec_for_fingerprint_op(fp_op)
    if spec is not None and spec.serialize is not None:
        return spec.serialize
    from .plan_cache import serialize_plan
    return serialize_plan


def deserializer_for(fp_op: str) -> Callable:
    """Flat dict → plan hook for a fingerprint op (generic by default)."""
    spec = _spec_for_fingerprint_op(fp_op)
    if spec is not None and spec.deserialize is not None:
        return spec.deserialize
    from .plan_cache import deserialize_plan
    return deserialize_plan
