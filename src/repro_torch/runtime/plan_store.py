"""Persistent plan store: the PlanCache spilled to disk, across restarts.

Copy of ``repro.runtime.plan_store``.  Store keys, the manifest, the
payload packing and the plan type names are the reference's, and plan
payloads are byte-equal to the reference's, so each package reads the
other's store.

REAP's one-time CPU pass is only "one-time" while the process lives; a
serve/train restart re-pays inspection for every pattern it had already
organized.  This module makes plans durable: a directory holding

  * ``manifest.json`` — schema-versioned index mapping *store keys* (a
    digest of the full :class:`PatternFingerprint`, including op tag and
    params) to payload metadata::

        {"schema": 1,
         "entries": {"<key>": {
             "fingerprint": {"op": ..., "shapes": [[r, c], ...],
                              "nnz": [...], "digest": "...",
                              "params": [["block", 128], ...]},
             "op": "spgemm_block_chunked",
             "payload": "<key>.npz",
             "sha256": "<hex digest of the payload bytes>",
             "bytes": 123456,
             "saved_at": 1690000000.0,
             "last_used": 1690000100.0}}}

  * ``plans/<key>.npz`` — the plan/chunk set through ``serialize_plan``
    (compressed, ``allow_pickle=False`` on load).

With a :class:`~repro_torch.runtime.shared_store.SharedBlobs` attached, the
payload instead lives once per *content* under the fleet-shared
``blobs/<sha256>`` layout and the manifest entry holds a
``blob:<sha256>`` ref — many processes, one plan namespace (see
shared_store.py for the refcounted GC and its safety argument).

Durability discipline (implemented in ``shared_store.StoreBase``, which
the reference's executable store shares):

  * **atomic writes** — payloads and the manifest are written to a temp
    file in the same directory and ``os.replace``d, so a crash mid-write
    never leaves a half-visible entry (at worst an orphan temp file that
    ``gc`` sweeps).
  * **content integrity** — ``get`` verifies the payload's sha256 against
    the manifest before deserializing; any mismatch, truncation, unreadable
    archive, or plan-schema drift drops the entry and returns a miss, so the
    caller transparently rebuilds (and write-through re-persists).
  * **schema versioning** — a manifest whose ``schema`` differs from
    :data:`SCHEMA_VERSION` (or that fails to parse) is moved aside and the
    store restarts empty: never crash a running job over stale state.
  * **byte-budget LRU** — ``gc`` evicts least-recently-used payloads until
    the store fits ``byte_budget`` and removes orphan files.

The store persists the *fingerprint itself*, so a fresh process can answer
``get(fp)`` for a pattern it has never inspected — the warm-restart
property (``RunStats.store_hit``).

CLI (``python -m repro_torch.runtime.plan_store``)::

    python -m repro_torch.runtime.plan_store ls     <store-dir>
    python -m repro_torch.runtime.plan_store verify <store-dir> [--prune]
    python -m repro_torch.runtime.plan_store gc     <store-dir> [--budget-mb N]
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.inspector import PatternFingerprint

from . import ops as _ops
from .plan_cache import deserialize_plan   # default payload deserializer
from .shared_store import (LOCKFILE, MANIFEST,  # noqa: F401  (re-exported
                           SCHEMA_VERSION, SharedBlobs,  # store contract)
                           StoreBase, fcntl)

PLANS_DIR = "plans"


# ---------------------------------------------------------------------------
# Payload packing: flat plan dict ⇄ 3-member npz
# ---------------------------------------------------------------------------
#
# ``serialize_plan`` flattens a chunk set into hundreds of small arrays; an
# npz with one zip member per array costs ~0.2 ms of Python header parsing
# *per member* on load, which would eat the warm-restart win.  The store
# therefore packs the flat dict into three members — ``__meta__`` (JSON:
# key, dtype, shape, offset, nbytes per array) and ``__blob__`` (every
# array's bytes, concatenated) plus ``__packed__`` (format marker) — so a
# load is one zip read + per-array ``np.frombuffer`` views.  Still a real
# npz (np.load-able), still exactly the ``serialize_plan`` dict inside.

_ALIGN = 16     # pad member offsets so unpack views are always aligned


def _pack_payload(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    meta, chunks, offset = [], [], 0
    for key in sorted(flat):
        arr = np.asarray(flat[key])
        stored = arr
        if arr.dtype == np.int64 and arr.size and \
                -2**31 <= int(arr.min()) and int(arr.max()) < 2**31:
            stored = arr.astype(np.int32)   # lossless: restored on unpack
        raw = np.ascontiguousarray(stored).tobytes()
        meta.append([key, stored.dtype.str, arr.dtype.str, list(arr.shape),
                     offset, len(raw)])
        pad = (-len(raw)) % _ALIGN
        chunks.append(raw + b"\0" * pad)
        offset += len(raw) + pad
    return {"__packed__": np.asarray(1),
            "__meta__": np.str_(json.dumps(meta)),
            "__blob__": np.frombuffer(b"".join(chunks), dtype=np.uint8)}


def _unpack_payload(data) -> Dict[str, np.ndarray]:
    if "__packed__" not in data:
        return dict(data)               # plain serialize_plan npz also loads
    meta = json.loads(str(data["__meta__"]))
    blob = np.asarray(data["__blob__"])
    out: Dict[str, np.ndarray] = {}
    for key, stored_dt, orig_dt, shape, offset, nbytes in meta:
        arr = blob[offset:offset + nbytes].view(np.dtype(stored_dt))
        if stored_dt != orig_dt:
            arr = arr.astype(np.dtype(orig_dt))   # restore (writable copy)
        elif not arr.flags.writeable:
            arr = np.array(arr)         # plans must own writable arrays
        out[key] = arr.reshape(shape)
    return out


def _read_npz_fast(blob: bytes) -> Dict[str, np.ndarray]:
    """Read an *uncompressed* npz held in memory without copying members.

    ``np.load``'s zipfile path CRC-checks and re-buffers every member —
    two extra passes over payloads whose sha256 was just verified.  This
    parses the zip central directory and views each member's ``.npy`` data
    in place (read-only views; :func:`_unpack_payload` copies what plans
    keep).  Raises on anything unexpected (compressed or misaligned
    members); callers fall back to ``np.load``.
    """
    import struct
    import zipfile
    from numpy.lib import format as npf

    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError("compressed member")
            off = info.header_offset
            if blob[off:off + 4] != b"PK\x03\x04":
                raise ValueError("bad local file header")
            nlen, elen = struct.unpack("<HH", blob[off + 26:off + 30])
            start = off + 30 + nlen + elen
            data = blob[start:start + info.file_size]
            bio = io.BytesIO(data)
            version = npf.read_magic(bio)
            shape, fortran, dtype = npf._read_array_header(bio, version)
            if fortran:
                raise ValueError("fortran-order member")
            arr = np.frombuffer(data, dtype=dtype, offset=bio.tell())
            out[info.filename[:-4] if info.filename.endswith(".npy")
                else info.filename] = arr.reshape(shape)
    return out


def _load_payload(blob: bytes, deserialize=None):
    """Payload bytes → plan, via the fast in-memory reader when possible.

    ``deserialize`` is the op's registered hook (``ops.deserializer_for``);
    ``None`` falls back to the generic ``plan_cache.deserialize_plan``.
    """
    deserialize = deserialize or deserialize_plan
    try:
        data = _read_npz_fast(blob)
    except Exception:
        with np.load(io.BytesIO(blob), allow_pickle=False) as data:
            return deserialize(_unpack_payload(data))
    return deserialize(_unpack_payload(data))


# ---------------------------------------------------------------------------
# Fingerprint ⇄ JSON (the manifest must be able to rebuild cache keys)
# ---------------------------------------------------------------------------

def fingerprint_to_json(fp: PatternFingerprint) -> dict:
    """Fingerprint → JSON-safe dict (tuples become lists)."""
    return {"op": fp.op,
            "shapes": [list(s) for s in fp.shapes],
            "nnz": list(fp.nnz),
            "digest": fp.digest,
            "params": [[k, v] for k, v in fp.params]}


def fingerprint_from_json(d: dict) -> PatternFingerprint:
    """Inverse of :func:`fingerprint_to_json` (hash-equal to the original)."""
    return PatternFingerprint(
        op=str(d["op"]),
        shapes=tuple(tuple(int(x) for x in s) for s in d["shapes"]),
        nnz=tuple(int(x) for x in d["nnz"]),
        digest=str(d["digest"]),
        params=tuple((str(k), v) for k, v in d["params"]))


def store_key(fp: PatternFingerprint) -> str:
    """Stable, filesystem-safe identity of a fingerprint across processes."""
    blob = json.dumps(fingerprint_to_json(fp), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


@dataclasses.dataclass
class StoreStats:
    """Per-process counters (the manifest carries the durable state)."""

    loads: int = 0      # payloads deserialized from disk (store hits)
    saves: int = 0      # payloads persisted
    corrupt: int = 0    # entries dropped on integrity/parse failure
    evicted: int = 0    # entries removed by the byte-budget gc
    errors: int = 0     # non-fatal persistence failures (kept computing)
    load_s: float = 0.0  # seconds spent in successful gets (the warm-restart
    #                      cost the benchmark compares against inspection)


class PlanStore(StoreBase):
    """Disk spill/load for inspector plans, keyed by pattern fingerprint.

    Thread-safe within a process.  Across processes, payload files are
    content-addressed and atomically replaced, and *manifest* mutations
    take an advisory ``manifest.lock`` (fcntl flock) under which the
    on-disk manifest is re-read and merged before writing — so multiple
    serve workers sharing one ``store_dir`` accumulate each other's
    entries instead of last-writer-wins clobbering.  Lock acquisition has
    a short timeout and falls through to the old best-effort in-memory
    behavior on contention (or on platforms without ``fcntl``): a lost
    entry is re-persisted by the next write-through, never corrupted.
    ``byte_budget=None`` disables the disk LRU.  ``shared`` (a
    ``SharedBlobs``) switches payloads to the fleet-shared
    content-addressed layout.
    """

    payload_dir_name = PLANS_DIR
    payload_suffix = ".npz"

    def __init__(self, root, byte_budget: Optional[int] = 1 << 30,
                 compress: bool = False,
                 shared: Optional[SharedBlobs] = None):
        super().__init__(root, byte_budget, StoreStats(), shared=shared)
        # uncompressed by default: a warm restart's win is load latency,
        # and the byte-budget gc already bounds the disk footprint
        self.compress = compress
        self._last_flush = 0.0          # throttles last_used persistence

    @property
    def _plans(self):
        return self._payload_dir

    # -- core API ----------------------------------------------------------

    def __contains__(self, fp: PatternFingerprint) -> bool:
        with self._lock:
            return store_key(fp) in self._load_manifest_locked()

    def get(self, fp: PatternFingerprint):
        """Load the plan persisted for ``fp``, or None.

        Integrity failures (bad digest, truncated/unreadable payload, plan
        schema drift) drop the entry and miss — the caller rebuilds and the
        write-through re-persists a good copy.
        """
        key = store_key(fp)
        t0 = time.perf_counter()
        with self._lock:
            ent = self._load_manifest_locked().get(key)
            if ent is None:
                return None
            path = self._payload_path(ent)
        try:
            blob = path.read_bytes()
            if hashlib.sha256(blob).hexdigest() != ent["sha256"]:
                raise ValueError(f"payload digest mismatch for {key}")
            plan = _load_payload(blob, _ops.deserializer_for(fp.op))
        except Exception:
            self.stats.corrupt += 1
            self._discard_corrupt_payload(ent)
            with self._manifest_flock() as locked:
                with self._lock:
                    if locked:
                        self._entries = None    # merge concurrent writers
                        self._load_manifest_locked()
                    cur = (self._entries or {}).get(key)
                    if cur is not None and \
                            cur.get("sha256") != ent["sha256"]:
                        # the mismatch came from OUR stale manifest view:
                        # a concurrent writer re-persisted this key and
                        # its fresh entry/payload are valid — leave them
                        # alone, just miss
                        return None
                    self._drop_locked(key)
                    try:
                        self._write_manifest_locked()
                    except OSError:
                        self.stats.errors += 1
            return None
        try:
            plan.fingerprint = fp
        except (AttributeError, TypeError):
            pass    # custom plan formats need not carry a fingerprint slot
        self.stats.loads += 1
        self.stats.load_s += time.perf_counter() - t0
        flush_due = False
        with self._lock:
            if key in (self._entries or {}):
                now = time.time()
                self._entries[key]["last_used"] = now
                # persist recency even in read-only processes (a restart
                # that only ever hits would otherwise look cold to a later
                # gc); throttled so a warm-restart burst costs one write.
                # The stamp advances for contended attempts too, so a
                # busy/unsupported lock costs one short spin per 5 s
                # window, not one per get.
                if now - self._last_flush > 5.0:
                    self._last_flush = now
                    flush_due = True
        if flush_due:
            # flock spin runs with self._lock RELEASED (lock order: flock
            # outer); recency is advisory, so on contention just skip
            with self._manifest_flock(timeout=0.1) as locked:
                if locked:
                    with self._lock:
                        # merge every in-memory recency update (all keys
                        # read since the last flush, not just this one)
                        # into the freshest on-disk view
                        mem = self._entries or {}
                        self._entries = None
                        entries = self._load_manifest_locked()
                        for k, e in mem.items():
                            if k in entries:
                                entries[k]["last_used"] = max(
                                    entries[k].get("last_used", 0.0),
                                    e.get("last_used", 0.0))
                        try:
                            self._write_manifest_locked()
                        except OSError:
                            self.stats.errors += 1
        return plan

    def put(self, fp: PatternFingerprint, plan) -> None:
        """Write-through persist: atomic payload write + manifest update.

        IO failures are counted in ``stats.errors`` and swallowed — the
        in-memory cache keeps working; durability is best-effort.
        """
        key = store_key(fp)
        try:
            serialize = _ops.serializer_for(fp.op)
            buf = io.BytesIO()
            save = np.savez_compressed if self.compress else np.savez
            save(buf, **_pack_payload(serialize(plan)))
            blob = buf.getvalue()
            sha = hashlib.sha256(blob).hexdigest()
            with self._manifest_flock() as locked:
                with self._lock:
                    if locked:
                        # merge-write: re-read the on-disk manifest so
                        # entries committed by other workers since our
                        # view was loaded survive this write (the lock
                        # makes it atomic)
                        self._entries = None
                    entries = self._load_manifest_locked()
                    payload_ref = self._persist_payload_locked(key, blob,
                                                               sha)
                    now = time.time()
                    entries[key] = {
                        "fingerprint": fingerprint_to_json(fp),
                        "op": fp.op,
                        "payload": payload_ref,
                        "sha256": sha,
                        "bytes": len(blob),
                        "saved_at": now,
                        "last_used": now}
                    self._gc_locked(self.byte_budget)
                    self._write_manifest_locked()
            self.stats.saves += 1
        except Exception:
            self.stats.errors += 1

    def fingerprints(self) -> List[PatternFingerprint]:
        """All persisted fingerprints (what a warm restart can answer)."""
        with self._lock:
            entries = self._load_manifest_locked()
            return [fingerprint_from_json(e["fingerprint"])
                    for e in entries.values()]

    # -- maintenance -------------------------------------------------------

    def verify(self, prune: bool = False) -> dict:
        """Check every payload against its manifest digest.

        Returns {"ok": [...], "corrupt": [...], "orphans": [...]};
        ``prune=True`` drops corrupt entries and orphan files.
        """
        with self._lock:
            entries = dict(self._load_manifest_locked())
        ok, corrupt = [], []
        for key, ent in entries.items():
            try:
                blob = self._payload_path(ent).read_bytes()
                if hashlib.sha256(blob).hexdigest() != ent["sha256"]:
                    raise ValueError("digest mismatch")
                _load_payload(blob, _ops.deserializer_for(ent.get("op", "")))
                ok.append(key)
            except Exception:
                corrupt.append(key)
        orphans = self._orphans(entries)
        if prune and (corrupt or orphans):
            with self._manifest_flock():
                with self._lock:
                    for key in corrupt:
                        self._drop_locked(key)
                    self._gc_locked(self.byte_budget, sweep=True)
                    self._write_manifest_locked()
            self.stats.corrupt += len(corrupt)
        return {"ok": ok, "corrupt": corrupt, "orphans": orphans}

    def summary(self) -> dict:
        with self._lock:
            entries = self._load_manifest_locked()
            return dict(entries=len(entries),
                        bytes=sum(int(e["bytes"]) for e in entries.values()),
                        loads=self.stats.loads, saves=self.stats.saves,
                        load_s=self.stats.load_s,
                        corrupt=self.stats.corrupt,
                        evicted=self.stats.evicted,
                        errors=self.stats.errors)


# ---------------------------------------------------------------------------
# CLI: ls / verify / gc
# ---------------------------------------------------------------------------

def _cli_ls(store: PlanStore) -> int:
    with store._lock:
        entries = store._load_manifest_locked()
    if not entries:
        print(f"plan store {store.root}: empty")
        return 0
    total = 0
    now = time.time()
    print(f"{'key':<34} {'op':<24} {'kB':>9} {'age':>8}  shapes")
    for key, ent in sorted(entries.items(), key=lambda kv: -kv[1]["bytes"]):
        total += int(ent["bytes"])
        shapes = "×".join("x".join(map(str, s))
                          for s in ent["fingerprint"]["shapes"])
        age_h = (now - ent["saved_at"]) / 3600.0
        print(f"{key:<34} {ent['op']:<24} {ent['bytes'] / 1e3:>9.1f} "
              f"{age_h:>7.1f}h  {shapes}")
    print(f"total: {len(entries)} plans, {total / 1e6:.2f} MB")
    return 0


def _cli_verify(store: PlanStore, prune: bool) -> int:
    report = store.verify(prune=prune)
    print(f"plan store {store.root}: {len(report['ok'])} ok, "
          f"{len(report['corrupt'])} corrupt, "
          f"{len(report['orphans'])} orphan files"
          f"{' (pruned)' if prune and (report['corrupt'] or report['orphans']) else ''}")
    for key in report["corrupt"]:
        print(f"  corrupt: {key}")
    for name in report["orphans"]:
        print(f"  orphan:  {name}")
    return 1 if report["corrupt"] and not prune else 0


def _cli_gc(store: PlanStore, budget_mb: Optional[float]) -> int:
    budget = None if budget_mb is None else int(budget_mb * 1e6)
    evicted = store.gc(budget)
    print(f"plan store {store.root}: evicted {len(evicted)} entries"
          f" → {store.summary()['bytes'] / 1e6:.2f} MB on disk")
    for key in evicted:
        print(f"  evicted: {key}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.plan_store",
        description="Inspect and maintain a persistent plan store.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ls = sub.add_parser("ls", help="list persisted plans")
    p_ls.add_argument("store", help="store directory")
    p_v = sub.add_parser("verify", help="check payload integrity")
    p_v.add_argument("store", help="store directory")
    p_v.add_argument("--prune", action="store_true",
                     help="drop corrupt entries and orphan files")
    p_gc = sub.add_parser("gc", help="evict LRU entries beyond the budget")
    p_gc.add_argument("store", help="store directory")
    p_gc.add_argument("--budget-mb", type=float, default=None,
                      help="byte budget in MB (default: store default 1 GB)")
    args = ap.parse_args(argv)
    store = PlanStore(args.store)
    if args.cmd == "ls":
        return _cli_ls(store)
    if args.cmd == "verify":
        return _cli_verify(store, args.prune)
    return _cli_gc(store, args.budget_mb)


if __name__ == "__main__":
    raise SystemExit(main())
