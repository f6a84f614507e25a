"""Kernel-library persistence: warm restarts that run no ``nvcc``.

Port of ``repro.runtime.exec_store``.  The reference persists XLA
executables so that a restarted process skips compilation.  The port's
executors are eager torch ops plus hand-written kernels bound with ctypes,
so the only compilation a process pays is ``nvcc`` building each
``kernels/csrc/<name>.cu`` into a shared library; this store makes that
durable.  There is no ``persistent_jit``: "a compile" here means one
``nvcc`` run.  Two layers:

``ExecStore``
    The durable layer: one entry per built library, under the same
    manifest discipline as the plan store (``shared_store.StoreBase``) —
    schema-versioned ``manifest.json``, flock merge-on-write, atomic
    writes, byte-budget disk LRU with put-time eviction, an orphan sweep in
    explicit maintenance, and a ``ls/verify/gc`` CLI.  Each payload's
    sha256 is checked *before* the library is handed to ``dlopen``: a
    corrupt file is a counted miss that rebuilds, never a load of bad
    machine code.  Entries record the ``environment()`` they were built
    under; a mismatch is a counted miss, never a crash.

``ExecCache``
    The per-process resolution layer ``kernels._build.load`` goes through
    when one is in effect (``use_exec_cache`` / ``set_default_exec_cache``):
    memory → store → ``nvcc`` (the fresh library is admitted to the store).
    Its key is the library's source digest (``_build.source_digest``: the
    ``.cu``, every ``.cuh`` and the flags) with the environment folded in.
    Counts ``compiles`` (``nvcc`` runs), ``loads`` (libraries from the
    store) and ``mem_hits``.

In a fleet directory (``shared_store.SharedBlobs``) the store's manifest
lives under ``kernels/``: the reference's ``exec/`` holds XLA payloads, and
each package's blob GC spares the other's refs.

CLI (``python -m repro_torch.runtime.exec_store``)::

    python -m repro_torch.runtime.exec_store ls     <store-dir>
    python -m repro_torch.runtime.exec_store verify <store-dir> [--prune]
    python -m repro_torch.runtime.exec_store gc     <store-dir> [--budget-mb N]
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import threading
import time
from typing import Dict, Iterable, List, Optional

from .shared_store import SharedBlobs, StoreBase

LIB_DIR = "lib"


def environment() -> Dict[str, str]:
    """The compatibility envelope of a built kernel library.

    The ``nvcc`` release and the card (name, compute capability) decide the
    machine code; the torch build and its CUDA version decide the runtime
    the library is loaded beside.  Any difference between a stored entry's
    environment and the current one is a miss — never an error.  Reads
    "none" / "not found" where there is no card or no ``nvcc``.
    """
    import torch

    from ..kernels import _build
    name, capability = "none", "none"
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        capability = "%d.%d" % torch.cuda.get_device_capability(0)
    return {"nvcc": _build.nvcc_version(), "torch": torch.__version__,
            "cuda": str(torch.version.cuda), "device_name": name,
            "capability": capability}


# ---------------------------------------------------------------------------
# ExecStore: the durable layer (same manifest discipline as the plan store)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecStoreStats:
    """Per-process counters (the manifest carries the durable state)."""

    loads: int = 0       # libraries read back (digest checked)
    saves: int = 0       # libraries persisted
    corrupt: int = 0     # entries dropped on integrity failure
    env_miss: int = 0    # entries skipped for environment mismatch
    evicted: int = 0     # entries removed by the byte-budget gc
    errors: int = 0      # non-fatal persistence failures (kept computing)
    load_s: float = 0.0  # seconds spent in successful loads


class ExecStore(StoreBase):
    """Disk store of built kernel libraries, keyed by ``ExecCache.key``.

    Thread-safe within a process; across processes the manifest takes the
    advisory ``manifest.lock`` + merge-on-write protocol of
    ``shared_store.StoreBase``, and payloads are atomically replaced.
    ``byte_budget=None`` disables the disk LRU.  ``shared`` (a
    ``SharedBlobs``) switches payloads to the fleet-shared content-addressed
    layout.
    """

    payload_dir_name = LIB_DIR
    payload_suffix = ".so"

    def __init__(self, root, byte_budget: Optional[int] = 1 << 30,
                 shared: Optional[SharedBlobs] = None):
        super().__init__(root, byte_budget, ExecStoreStats(), shared=shared)
        self.env = environment()

    # -- core API ----------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        """The library bytes persisted under ``key``, digest-checked.

        Returns None on a miss.  Environment mismatch is a plain miss
        (``stats.env_miss``); a payload whose sha256 disagrees with its
        entry is dropped and missed (``stats.corrupt``) so the caller
        rebuilds and re-persists a good copy.  Bytes returned have matched
        their digest: only those may reach ``dlopen``.
        """
        t0 = time.perf_counter()
        with self._lock:
            ent = self._load_manifest_locked().get(key)
            if ent is None:
                return None
            if ent.get("env") != self.env:
                self.stats.env_miss += 1
                return None
            path = self._payload_path(ent)
        try:
            blob = path.read_bytes()
            good = hashlib.sha256(blob).hexdigest() == ent["sha256"]
        except OSError:
            good = False
        if not good:
            self._drop_corrupt(key, ent)
            return None
        self.stats.loads += 1
        self.stats.load_s += time.perf_counter() - t0
        return blob

    def _drop_corrupt(self, key: str, ent: dict) -> None:
        self.stats.corrupt += 1
        self._discard_corrupt_payload(ent)
        with self._manifest_flock() as locked:
            with self._lock:
                if locked:
                    self._entries = None        # merge concurrent writers
                    self._load_manifest_locked()
                cur = (self._entries or {}).get(key)
                if cur is not None and cur.get("sha256") != ent["sha256"]:
                    # our manifest view was stale; a concurrent writer
                    # re-persisted this key — leave its entry alone
                    return
                self._drop_locked(key)
                try:
                    self._write_manifest_locked()
                except OSError:
                    self.stats.errors += 1

    def put(self, key: str, blob: bytes, label: str = "") -> bool:
        """Atomically persist one built library.  Returns True on success;
        IO failures are counted and swallowed — persistence is best-effort,
        a kernel never fails to load over the disk."""
        try:
            sha = hashlib.sha256(blob).hexdigest()
            with self._manifest_flock() as locked:
                with self._lock:
                    if locked:
                        self._entries = None    # merge-write freshest view
                    entries = self._load_manifest_locked()
                    payload_ref = self._persist_payload_locked(key, blob,
                                                               sha)
                    now = time.time()
                    entries[key] = {
                        "payload": payload_ref,
                        "sha256": sha,
                        "bytes": len(blob),
                        "env": dict(self.env),
                        "label": label,
                        "saved_at": now,
                        "last_used": now}
                    self._gc_locked(self.byte_budget)
                    self._write_manifest_locked()
            self.stats.saves += 1
            return True
        except OSError:
            self.stats.errors += 1
            return False

    # -- maintenance -------------------------------------------------------

    def verify(self, prune: bool = False) -> dict:
        """Check every payload's sha256 and environment.

        Returns {"ok": [...], "corrupt": [...], "stale_env": [...],
        "orphans": [...]}; ``prune=True`` drops corrupt/stale entries and
        orphan files.
        """
        with self._lock:
            entries = dict(self._load_manifest_locked())
        ok, corrupt, stale = [], [], []
        for key, ent in entries.items():
            try:
                blob = self._payload_path(ent).read_bytes()
                good = hashlib.sha256(blob).hexdigest() == ent["sha256"]
            except OSError:
                good = False
            if not good:
                corrupt.append(key)
            elif ent.get("env") != self.env:
                stale.append(key)
            else:
                ok.append(key)
        orphans = self._orphans(entries)
        if prune and (corrupt or stale or orphans):
            with self._manifest_flock():
                with self._lock:
                    for key in corrupt + stale:
                        self._drop_locked(key)
                    self._gc_locked(self.byte_budget, sweep=True)
                    self._write_manifest_locked()
            self.stats.corrupt += len(corrupt)
        return {"ok": ok, "corrupt": corrupt, "stale_env": stale,
                "orphans": orphans}

    def summary(self) -> dict:
        with self._lock:
            entries = self._load_manifest_locked()
            return dict(entries=len(entries),
                        bytes=sum(int(e["bytes"]) for e in entries.values()),
                        loads=self.stats.loads, saves=self.stats.saves,
                        load_s=self.stats.load_s,
                        corrupt=self.stats.corrupt,
                        env_miss=self.stats.env_miss,
                        evicted=self.stats.evicted,
                        errors=self.stats.errors)


# ---------------------------------------------------------------------------
# ExecCache: memory → store → nvcc, with the compile counter the gates read
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecCacheStats:
    compiles: int = 0        # nvcc runs paid through the cache
    mem_hits: int = 0        # answered from the in-process table
    loads: int = 0           # answered from the store
    saves: int = 0           # newly built libraries persisted
    compile_s: float = 0.0   # seconds spent in nvcc
    load_s: float = 0.0      # seconds spent loading from the store


class ExecCache:
    """Per-process kernel-library resolution over an optional ``ExecStore``.

    ``store=None`` still loads each library once per process; it just has
    nothing durable to consult.
    """

    def __init__(self, store: Optional[ExecStore] = None):
        self.store = store
        self.env = store.env if store is not None else environment()
        self.stats = ExecCacheStats()
        self._mem: Dict[str, object] = {}       # key → loaded library
        self._keys: Dict[str, str] = {}         # kernel name → key
        self._lock = threading.Lock()

    def key(self, name: str) -> str:
        """The store key of ``csrc/<name>.cu`` under this environment."""
        key = self._keys.get(name)
        if key is None:
            from ..kernels import _build
            key = self._keys[name] = hashlib.blake2b(repr((
                "kernel_library", name, _build.source_digest(name),
                tuple(sorted(self.env.items())))).encode(),
                digest_size=16).hexdigest()
        return key

    def load(self, name: str):
        """The loaded library of ``csrc/<name>.cu`` (memory → store →
        ``nvcc``)."""
        return self.load_many((name,))[name]

    def load_many(self, names: Iterable[str]) -> Dict[str, object]:
        """Load every named library; the misses build together (one
        ``nvcc`` each, all started at once) and are admitted to the store.
        A failed build raises."""
        from ..kernels import _build
        out: Dict[str, object] = {}
        with self._lock:
            missing: List[str] = []
            for name in dict.fromkeys(names):
                key = self.key(name)
                lib = self._mem.get(key)
                if lib is not None:
                    self.stats.mem_hits += 1
                    out[name] = lib
                    continue
                blob = None
                if self.store is not None:
                    t0 = time.perf_counter()
                    blob = self.store.get(key)
                if blob is None:
                    missing.append(name)
                    continue
                lib = self._mem[key] = out[name] = _build.open_library(
                    name, blob)
                self.stats.loads += 1
                self.stats.load_s += time.perf_counter() - t0
            if missing:
                t0 = time.perf_counter()
                blobs = _build.compile_libraries(missing)
                self.stats.compile_s += time.perf_counter() - t0
                for name in missing:
                    self.stats.compiles += 1
                    key = self.key(name)
                    if self.store is not None and self.store.put(
                            key, blobs[name], label=name):
                        self.stats.saves += 1
                    self._mem[key] = out[name] = _build.open_library(
                        name, blobs[name])
        return out

    def summary(self) -> dict:
        out = dataclasses.asdict(self.stats)
        out["mem_entries"] = len(self._mem)
        if self.store is not None:
            out["store"] = self.store.summary()
        return out


# ---------------------------------------------------------------------------
# The process-default / context exec cache ``kernels._build.load`` consults
# ---------------------------------------------------------------------------

_DEFAULT_EXEC: Optional[ExecCache] = None
_CONTEXT_EXEC: contextvars.ContextVar = contextvars.ContextVar(
    "reap_exec_cache", default=None)


def set_default_exec_cache(cache: Optional[ExecCache]) -> None:
    """Install (or clear) the process-wide exec cache.

    ``runtime.set_default_runtime`` calls this, so every kernel a process
    launches — in registry executors and in the serve scheduler's model
    alike — resolves its library through the configured store.
    """
    global _DEFAULT_EXEC
    _DEFAULT_EXEC = cache


def current_exec_cache() -> Optional[ExecCache]:
    """The exec cache in effect: innermost ``use_exec_cache`` or default."""
    ctx = _CONTEXT_EXEC.get()
    return ctx if ctx is not None else _DEFAULT_EXEC


@contextlib.contextmanager
def use_exec_cache(cache: Optional[ExecCache]):
    """Scoped override: ``ReapRuntime.run`` wraps execution in its own
    cache so per-runtime stores work without global mutation."""
    token = _CONTEXT_EXEC.set(cache)
    try:
        yield cache
    finally:
        _CONTEXT_EXEC.reset(token)


# ---------------------------------------------------------------------------
# CLI: ls / verify / gc
# ---------------------------------------------------------------------------

def _cli_ls(store: ExecStore) -> int:
    with store._lock:
        entries = store._load_manifest_locked()
    if not entries:
        print(f"exec store {store.root}: empty")
        return 0
    total, stale = 0, 0
    now = time.time()
    print(f"{'key':<34} {'kB':>9} {'age':>8} {'env':>6}  label")
    for key, ent in sorted(entries.items(), key=lambda kv: -kv[1]["bytes"]):
        total += int(ent["bytes"])
        match = ent.get("env") == store.env
        stale += 0 if match else 1
        age_h = (now - ent["saved_at"]) / 3600.0
        print(f"{key:<34} {ent['bytes'] / 1e3:>9.1f} {age_h:>7.1f}h "
              f"{'ok' if match else 'stale':>6}  {ent.get('label', '')}")
    print(f"total: {len(entries)} kernel libraries, {total / 1e6:.2f} MB"
          f"{f', {stale} stale-env' if stale else ''}")
    return 0


def _cli_verify(store: ExecStore, prune: bool) -> int:
    report = store.verify(prune=prune)
    pruned = prune and (report["corrupt"] or report["stale_env"]
                        or report["orphans"])
    print(f"exec store {store.root}: {len(report['ok'])} ok, "
          f"{len(report['corrupt'])} corrupt, "
          f"{len(report['stale_env'])} stale-env, "
          f"{len(report['orphans'])} orphan files"
          f"{' (pruned)' if pruned else ''}")
    for key in report["corrupt"]:
        print(f"  corrupt:   {key}")
    for key in report["stale_env"]:
        print(f"  stale-env: {key}")
    for name in report["orphans"]:
        print(f"  orphan:    {name}")
    return 1 if report["corrupt"] and not prune else 0


def _cli_gc(store: ExecStore, budget_mb: Optional[float]) -> int:
    budget = None if budget_mb is None else int(budget_mb * 1e6)
    evicted = store.gc(budget)
    print(f"exec store {store.root}: evicted {len(evicted)} entries"
          f" → {store.summary()['bytes'] / 1e6:.2f} MB on disk")
    for key in evicted:
        print(f"  evicted: {key}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.exec_store",
        description="Inspect and maintain a persistent kernel-library "
                    "store.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ls = sub.add_parser("ls", help="list persisted kernel libraries")
    p_ls.add_argument("store", help="store directory")
    p_v = sub.add_parser("verify", help="check payload integrity + env")
    p_v.add_argument("store", help="store directory")
    p_v.add_argument("--prune", action="store_true",
                     help="drop corrupt/stale entries and orphan files")
    p_gc = sub.add_parser("gc", help="evict LRU entries beyond the budget")
    p_gc.add_argument("store", help="store directory")
    p_gc.add_argument("--budget-mb", type=float, default=None,
                      help="byte budget in MB (default: store default 1 GB)")
    args = ap.parse_args(argv)
    store = ExecStore(args.store)
    if args.cmd == "ls":
        return _cli_ls(store)
    if args.cmd == "verify":
        return _cli_verify(store, args.prune)
    return _cli_gc(store, args.budget_mb)


if __name__ == "__main__":
    raise SystemExit(main())
