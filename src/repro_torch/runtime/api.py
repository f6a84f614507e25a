"""ReapRuntime: a generic dispatcher over the registered planned-op protocol.

Port of ``repro.runtime.api``.  Every sparse operation factors into the same
stages — pattern fingerprint, plan build (cache miss only), bundle emit +
execution, with host/device overlap when the schedule is chunkable — and

    result, stats = ReapRuntime().run(op_tag, *operands, **kw)

drives *any* registered op through one fingerprint → cache-lookup →
inspect → execute → stats path.  ``spgemm`` / ``cholesky`` remain as thin
wrappers over ``run(...)``.

Same pattern + different values ⇒ cache hit ⇒ the inspector cost from the
paper's Fig 7 split drops out of the steady state entirely.  The runtime
owns no executor of its own: specs hand cached plans to the same planned
entry points the library exposes (``core.spgemm.spgemm(plan=...)``,
``core.cholesky.cholesky(plan=...)``, ``runtime.pipeline``).

Executors run on ``RuntimeConfig.device`` (``cuda`` unless the caller asks
for ``cpu``); a runtime built for CUDA on a machine without a card raises.
The plan store and the fleet store's plan half are ported; the executable
store and sharding are not yet: their config fields exist and raise
``NotImplementedError`` when set.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import ops as _ops
from .plan_cache import PlanCache

# config fields of features a later slice ports, and the ROADMAP item
# (queue 1) that ports each
_NOT_PORTED = {
    "exec_store_dir": "queue 1 item 12 (kernel library store)",
    "mesh_shape": "queue 1 item 9 (sharding)",
}


@dataclasses.dataclass
class RuntimeConfig:
    """Knobs of the runtime; every field participates in plan fingerprints
    that depend on it (tile/block/n_chunks).

    ``device`` names where executors run: ``"cuda"`` (default) or
    ``"cpu"``.  ``use_kernel`` picks the hand-written kernel (K1) for the
    block path over its plain PyTorch version; on CPU tensors both run the
    plain version.

    ``store_dir`` attaches a persistent plan store (plan_store.PlanStore):
    the manifest is consulted lazily on the first miss, and every newly
    built plan is write-through-persisted, so a restarted process starts
    warm for every pattern any previous run inspected.

    ``shared_store_dir`` attaches the plan store under a fleet-shared,
    content-addressed layout (shared_store.SharedBlobs): every process
    pointed at the same directory — of either package — shares one plan
    namespace.  An explicit ``store_dir`` wins.  Only the plan half is
    attached: the reference's executable half has no port yet.

    ``exec_store_dir`` and ``mesh_shape`` keep the reference's fields;
    setting either raises ``NotImplementedError`` naming the ROADMAP item
    that ports it.  The executable store's ``exec_budget_bytes`` comes back
    with that store.

    Entry points build the config with ``RuntimeConfig.from_args`` over a
    parser extended by ``add_runtime_args``; programmatic callers use the
    constructor or ``dataclasses.replace``.
    """

    cache_entries: int = 64
    overlap: bool = True
    n_chunks: int = 4
    tile: int = 1024
    block: int = 128
    use_kernel: bool = True
    moe_capacity_factor: float = 1.25
    store_dir: Optional[str] = None
    store_budget_bytes: int = 1 << 30
    exec_store_dir: Optional[str] = None
    shared_store_dir: Optional[str] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    device: str = "cuda"

    @classmethod
    def from_args(cls, args: Any, **overrides) -> "RuntimeConfig":
        """Build a config from an ``add_runtime_args``-extended namespace.

        Missing attributes are tolerated (a parser may opt into a subset of
        the flags), and ``overrides`` — the entry point's own non-CLI
        choices — win last.
        """
        kw: Dict[str, Any] = {}
        plan_dir = getattr(args, "plan_store", None)
        if plan_dir is not None:
            kw["store_dir"] = plan_dir
        plan_mb = getattr(args, "plan_store_budget_mb", None)
        if plan_mb is not None:
            kw["store_budget_bytes"] = int(plan_mb * 1e6)
        exec_dir = getattr(args, "exec_store", None)
        if exec_dir is not None:
            kw["exec_store_dir"] = exec_dir
        shared_dir = getattr(args, "shared_store", None)
        if shared_dir is not None:
            kw["shared_store_dir"] = shared_dir
        mesh_shape = getattr(args, "mesh_shape", None)
        if mesh_shape is not None:
            kw["mesh_shape"] = parse_mesh_shape(mesh_shape)
        entries = getattr(args, "cache_entries", None)
        if entries is not None:
            kw["cache_entries"] = entries
        n_chunks = getattr(args, "n_chunks", None)
        if n_chunks is not None:
            kw["n_chunks"] = n_chunks
        if getattr(args, "no_overlap", False):
            kw["overlap"] = False
        if getattr(args, "no_kernel", False):
            kw["use_kernel"] = False
        device = getattr(args, "device", None)
        if device is not None:
            kw["device"] = device
        kw.update(overrides)
        return cls(**kw)


def parse_mesh_shape(text: Any) -> Optional[Tuple[int, ...]]:
    """``"8"`` → ``(8,)``; ``"2x4"`` → ``(2, 4)``; tuples pass through;
    ``None`` stays ``None`` (no mesh configured)."""
    if text is None:
        return None
    if isinstance(text, (tuple, list)):
        return tuple(int(n) for n in text)
    parts = [p for p in str(text).lower().replace(",", "x").split("x") if p]
    if not parts:
        raise ValueError(f"empty mesh shape {text!r}")
    shape = tuple(int(p) for p in parts)
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    return shape


def add_runtime_args(parser) -> None:
    """Install the shared runtime-construction flags on ``parser``.

    Every CLI entry point that builds a ``ReapRuntime`` uses this one
    helper plus ``RuntimeConfig.from_args``.  Numeric defaults are None so
    ``from_args`` only overrides what the user actually set.  The
    executable-store and mesh flags are accepted and raise at runtime
    construction until their slice is ported.
    """
    g = parser.add_argument_group("runtime")
    g.add_argument("--plan-store", metavar="DIR", default=None,
                   help="persist inspection plans under DIR; restarted "
                        "processes skip re-inspection for known patterns")
    g.add_argument("--plan-store-budget-mb", type=float, default=None,
                   metavar="MB", help="plan-store disk LRU budget")
    g.add_argument("--exec-store", metavar="DIR", default=None,
                   help="persist compiled executables under DIR (not "
                        "ported yet: raises)")
    g.add_argument("--shared-store", metavar="DIR", default=None,
                   help="fleet store: the plan store under DIR, backed by "
                        "a content-addressed blob area that processes of "
                        "either package share (plan half only)")
    g.add_argument("--mesh-shape", metavar="N[xM]", default=None,
                   help="device mesh for shardable ops (not ported yet: "
                        "raises)")
    g.add_argument("--cache-entries", type=int, default=None,
                   help="in-memory plan cache capacity")
    g.add_argument("--n-chunks", type=int, default=None,
                   help="inspector/executor overlap chunk count "
                        "(1 disables chunking)")
    g.add_argument("--no-overlap", action="store_true",
                   help="run chunked ops synchronously")
    g.add_argument("--no-kernel", action="store_true",
                   help="run the block path's plain PyTorch version instead "
                        "of kernel K1")
    g.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where executors run (default cuda)")


@dataclasses.dataclass
class RunStats:
    """Typed stats record returned by ``ReapRuntime.run``.

    The declared fields mirror ``ops.RUNSTATS_FIELDS`` (reaplint REAP002
    rejects ad-hoc stats-key writes in the runtime that are not declared
    here).  Op executors still report their own measurements (``method``,
    ``execute_s``, overlap counters, ...) — those ride in ``extra`` and
    stay reachable through the dict-style interface, so pre-existing
    ``stats["method"]`` / ``stats.get("plan_s", 0.0)`` consumers are
    unaffected.  A None field means "not applicable to this run" (e.g.
    ``exec_cache_hit`` without an exec store) and is absent from the
    mapping view.
    """

    cache_hit: Optional[bool] = None
    store_hit: Optional[bool] = None
    exec_cache_hit: Optional[bool] = None
    fingerprint: Optional[str] = None
    inspect_s: Optional[float] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _FIELDS = _ops.RUNSTATS_FIELDS

    def __post_init__(self):
        assert self._FIELDS == tuple(
            f.name for f in dataclasses.fields(self) if f.name != "extra"), \
            "RunStats fields drifted from ops.RUNSTATS_FIELDS"

    # -- dict-style back-compat -------------------------------------------

    def _mapping(self) -> Dict[str, Any]:
        out = dict(self.extra)
        for name in self._FIELDS:
            val = getattr(self, name)
            if val is not None:
                out[name] = val
        return out

    def __getitem__(self, key: str) -> Any:
        if key in self._FIELDS:
            val = getattr(self, key)
            if val is not None:
                return val
        return self.extra[key]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: object) -> bool:
        return key in self._mapping()

    def __iter__(self) -> Iterator[str]:
        return iter(self._mapping())

    def __len__(self) -> int:
        return len(self._mapping())

    def keys(self):
        return self._mapping().keys()

    def values(self):
        return self._mapping().values()

    def items(self):
        return self._mapping().items()

    def asdict(self) -> Dict[str, Any]:
        """Flat dict view (JSON-friendly; None fields omitted)."""
        return self._mapping()


# route decisions are tiny per-pattern strings; anything bigger in the
# route cache is a bug (a plan put under a route key), so puts are guarded
_ROUTE_ENTRY_BYTES = 4096


class ReapRuntime:
    """Cached + overlapped REAP runtime (one instance per worker/process)."""

    def __init__(self, config: Optional[RuntimeConfig] = None, **overrides):
        cfg = config or RuntimeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        for field, item in _NOT_PORTED.items():
            if getattr(cfg, field) is not None:
                raise NotImplementedError(
                    f"RuntimeConfig.{field} is not ported to repro_torch "
                    f"yet; ROADMAP.md {item} ports it")
        self.device = resolve_device(cfg.device)
        self.config = cfg
        self.shared = None
        if cfg.shared_store_dir is not None:
            from .shared_store import PLANS_SUBDIR, SharedBlobs
            self.shared = SharedBlobs(cfg.shared_store_dir)
        self.store = None
        if cfg.store_dir is not None:        # explicit dir wins: local store
            from .plan_store import PlanStore
            self.store = PlanStore(cfg.store_dir, cfg.store_budget_bytes)
        elif self.shared is not None:
            from .plan_store import PlanStore
            self.store = PlanStore(self.shared.store_root(PLANS_SUBDIR),
                                   cfg.store_budget_bytes,
                                   shared=self.shared)
        self.cache = PlanCache(cfg.cache_entries, store=self.store)
        # routing decisions are tiny strings; keep them out of the plan
        # cache so they neither consume plan capacity nor skew hit stats
        self._routes = PlanCache(capacity=max(256, 4 * cfg.cache_entries),
                                 max_entry_bytes=_ROUTE_ENTRY_BYTES)
        self._op_stats: Dict[str, Dict[str, int]] = {}
        self._op_stats_lock = threading.Lock()
        # cache.clear() resets the per-op split too, so the aggregate and
        # per-op views of cache_stats() can never contradict each other
        self.cache.on_clear = self._reset_op_stats

    def _reset_op_stats(self) -> None:
        with self._op_stats_lock:
            self._op_stats.clear()

    # -- Generic dispatch --------------------------------------------------

    def run(self, op_tag: str, *operands, overlap: Optional[bool] = None,
            mesh: Optional[object] = None,
            **kw) -> Tuple[object, "RunStats"]:
        """Execute a registered planned op through the cache/pipeline.

        Returns ``(result, stats)``; ``result`` is op-defined (the
        wrappers unpack it).  ``stats`` is a ``RunStats`` (dict-compatible):
        always ``cache_hit`` and ``fingerprint``; synchronous calls also get
        ``inspect_s`` (plan acquisition time — ≈ digest cost when warm).
        ``mesh`` (sharded execution) is not ported yet and raises.
        """
        if mesh is not None:
            raise NotImplementedError(
                "sharded execution is not ported to repro_torch yet; "
                f"ROADMAP.md {_NOT_PORTED['mesh_shape']} ports it")
        spec = _ops.get_op(op_tag)
        hops = 0
        while spec.route is not None:          # resolve router/alias ops
            op_tag, kw = spec.route(operands, self.config, self._routes,
                                    **kw)
            spec = _ops.get_op(op_tag)
            hops += 1
            if hops > 4:
                raise RuntimeError(f"op route loop resolving {op_tag!r}")
        cfg = self.config
        if spec.allowed_kw is not None:
            unknown = set(kw) - set(spec.allowed_kw)
            if unknown:
                raise TypeError(
                    f"op {op_tag!r} got unexpected keyword arguments "
                    f"{sorted(unknown)}; accepts {sorted(spec.allowed_kw)}")
        overlap = cfg.overlap if overlap is None else overlap
        chunked = spec.execute_chunked is not None and cfg.n_chunks > 1
        if spec.prepare is not None:    # derive once what fingerprint +
            kw = spec.prepare(operands, cfg, **kw)   # inspect both need
        fp = spec.fingerprint(operands, cfg, chunked=chunked, **kw)

        inspect_s: Optional[float] = None
        if chunked:
            cached, source = self.cache.get_with_source(fp)
            self._record_op(op_tag, source)
            result, op_stats, artifact = spec.execute_chunked(
                cached, operands, cfg, overlap=overlap, **kw)
            if cached is None and artifact is not None:
                try:
                    artifact.fingerprint = fp
                except (AttributeError, TypeError):
                    pass    # custom artifacts need not carry a slot
                self.cache.put(fp, artifact)
            hit = cached is not None
        else:
            t0 = time.perf_counter()
            plan, source = self.cache.get_with_source(fp)
            self._record_op(op_tag, source)
            if plan is None:
                plan = spec.inspect(operands, cfg, fp, **kw)
                self.cache.put(fp, plan)
            inspect_s = time.perf_counter() - t0
            hit = source is not None
            result, op_stats = spec.execute_sync(plan, operands, cfg,
                                                 overlap=overlap, **kw)
        return result, RunStats(
            cache_hit=hit,
            store_hit=source == "store",
            fingerprint=fp.digest,
            inspect_s=inspect_s,
            extra=dict(op_stats))

    def _record_op(self, op_tag: str, source: Optional[str]) -> None:
        """Tally the per-op split at cache-acquisition time — the same
        moment the aggregate CacheStats counter moves — so the two views
        agree even when the executor later raises."""
        with self._op_stats_lock:
            rec = self._op_stats.setdefault(
                op_tag, dict(hits=0, store_hits=0, misses=0))
            rec["hits" if source == "memory"
                else "store_hits" if source == "store" else "misses"] += 1

    # -- Thin wrappers over run --------------------------------------------

    def spgemm(self, a, b, method: str = "auto",
               overlap: Optional[bool] = None) -> Tuple[object, dict]:
        """C = A @ B through the plan cache, overlapped when chunkable."""
        return self.run("spgemm", a, b, method=method, overlap=overlap)

    def cholesky(self, a, dtype=torch.float64,
                 overlap: Optional[bool] = None):
        """A = L Lᵀ through the plan cache; level-bundle emission overlaps
        device execution (the etree schedule is the chunk stream).
        Returns (plan, L values, stats)."""
        (plan, vals), stats = self.run("cholesky", a, dtype=dtype,
                                       overlap=overlap)
        return plan, vals, stats

    def moe_dispatch(self, tokens, expert_ids, *, n_experts: int,
                     capacity: Optional[int] = None):
        """Plan-cached MoE dispatch: tokens → (n_experts, capacity, d) RIR
        bundles for the grouped expert GEMM (kernels.moe_gemm).

        The token→expert assignment (``expert_ids``, from the router —
        ``models.moe.host_route``) is the sparsity pattern here: it is
        fingerprinted under the ``moe_dispatch`` op tag, so repeated
        routings hit a warm bundling plan and the dispatch cost collapses
        to two gathers.  Gate values never enter the key; pass them to
        ``plan.combine`` after the expert GEMM.  Numpy tokens give numpy
        bundles; a tensor gives bundles on the runtime's device.
        Returns (x_bundles, plan, stats)."""
        if not torch.is_tensor(tokens):
            tokens = np.asarray(tokens)
        (x_bundles, plan), stats = self.run(
            "moe_dispatch", tokens, expert_ids, n_experts=n_experts,
            capacity=capacity)
        return x_bundles, plan, stats

    # -- Introspection -----------------------------------------------------

    def cache_stats(self) -> dict:
        s = self.cache.stats
        out = dict(entries=len(self.cache), capacity=self.cache.capacity,
                   hits=s.hits, misses=s.misses, evictions=s.evictions,
                   store_hits=s.store_hits, hit_rate=s.hit_rate)
        # per-op-tag breakdown: every registered op reports, active or not
        per_op = {tag: dict(hits=0, store_hits=0, misses=0)
                  for tag in _ops.list_ops()}
        with self._op_stats_lock:
            for tag, rec in self._op_stats.items():
                per_op.setdefault(tag, dict(hits=0, store_hits=0, misses=0))
                for k, v in rec.items():
                    per_op[tag][k] += v
        for rec in per_op.values():
            # warm = any plan served without a fresh inspection
            warm = rec["hits"] + rec["store_hits"]
            total = warm + rec["misses"]
            rec["warm_rate"] = warm / total if total else 0.0
        out["per_op"] = per_op
        if self.store is not None:
            out["store"] = self.store.summary()
        return out


_DEFAULT: Optional[ReapRuntime] = None


def default_runtime() -> ReapRuntime:
    """Process-wide shared runtime (lazy; built on the default device)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ReapRuntime()
    return _DEFAULT


def set_default_runtime(rt: Optional[ReapRuntime]) -> Optional[ReapRuntime]:
    """Install ``rt`` as the process-wide runtime."""
    global _DEFAULT
    _DEFAULT = rt
    return rt


def configure_default_runtime(config: Optional[RuntimeConfig] = None,
                              **overrides) -> ReapRuntime:
    """Deprecated: build via ``RuntimeConfig`` (or ``from_args``) and
    install with ``set_default_runtime`` instead."""
    warnings.warn(
        "configure_default_runtime is deprecated; build a RuntimeConfig "
        "(RuntimeConfig.from_args for CLI entry points) and install it "
        "with set_default_runtime(ReapRuntime(cfg))",
        DeprecationWarning, stacklevel=2)
    return set_default_runtime(ReapRuntime(config, **overrides))
