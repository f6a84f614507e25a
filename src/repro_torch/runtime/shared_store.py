"""Content-addressed fleet store: one payload namespace, many manifests.

Copy of ``repro.runtime.shared_store`` (numpy-free, stdlib only).  The
layout, manifest schema and payload refs are the reference's, so a fleet
directory is shared by processes of both packages: ``SharedBlobs.gc``
counts the refs of *every* manifest directory under the root — the
reference's ``exec/`` store included, though the port writes only
``plans/`` — and never removes a blob any of them references.

In the reference, the plan store (plan_store.py) and the executable store
(exec_store.py; not ported) each made one half of the REAP split durable per *directory*; a fleet of
serve processes pointed at per-host directories still warms per-host.
This module closes that gap with two layers:

:class:`StoreBase`
    The manifest discipline both stores had grown independently — lazy
    schema-versioned ``manifest.json``, advisory ``manifest.lock`` flock
    with merge-on-write, atomic tmp+replace writes, byte-budget disk LRU,
    orphan sweeps gated to explicit maintenance — deduplicated into one
    base class.  Behavior is bit-for-bit what the two stores did before;
    only the duplication moved.

:class:`SharedBlobs`
    A content-addressed payload layout shared by *both* stores::

        <shared_root>/blobs/<sha256>     one blob per distinct content
        <shared_root>/plans/manifest.json   a PlanStore root (refs only)
        <shared_root>/exec/manifest.json    an ExecStore root (refs only)

    Manifest entries whose ``payload`` is ``"blob:<sha256>"`` resolve
    against ``blobs/``; identical content (the common case: every process
    in the fleet re-inspecting the same pattern) is stored once, and a
    store dropping its *ref* (LRU eviction, corruption recovery) never
    unlinks the blob — other manifests may still reference it.  That is
    the implicit refcount; :meth:`SharedBlobs.gc` is the reclaimer.

GC safety argument (why ``gc`` never drops a payload a live manifest
references):

* the sweep holds **every** manifest flock, acquired in sorted directory
  order, while it computes the referenced-sha set *and* unlinks — so no
  store can commit a new ref between "unreferenced" and "deleted";
* writers add the blob and commit the manifest ref under their own
  manifest flock (one critical section), so a held flock means no
  half-published ref exists for that store;
* blobs younger than the grace window (default 1 h) are spared
  unconditionally, covering the lockless fallback path (platforms
  without ``fcntl``, or a writer that timed out on a contended lock and
  proceeded best-effort) — :meth:`SharedBlobs.add` refreshes the mtime on
  dedup hits so the window always covers the gap between blob write and
  manifest commit;
* a manifest that fails to parse contributes no refs, but its store
  restarts empty on next load anyway (the ``.corrupt`` move-aside), so
  those refs were already lost to their owner — skipping them cannot
  strand a *live* entry.

CLI (``python -m repro_torch.runtime.shared_store``)::

    python -m repro_torch.runtime.shared_store ls     <shared-root>
    python -m repro_torch.runtime.shared_store verify <shared-root>
    python -m repro_torch.runtime.shared_store gc     <shared-root> [--grace-s N]
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

try:
    import fcntl
except ImportError:                      # non-POSIX: lockless best-effort
    fcntl = None

SCHEMA_VERSION = 1
MANIFEST = "manifest.json"
LOCKFILE = "manifest.lock"
BLOBS_DIR = "blobs"
#: manifest ``payload`` prefix marking a content-addressed ref
BLOB_PREFIX = "blob:"
#: default sub-roots a shared layout gives the two stores
PLANS_SUBDIR = "plans"
EXEC_SUBDIR = "exec"


@contextlib.contextmanager
def _dir_flock(root: Path, timeout: float):
    """Advisory cross-process lock on ``root/manifest.lock``.

    Yields True when acquired; False on timeout or unsupported platform
    (callers proceed best-effort).  Non-blocking spin so a contended lock
    never parks the thread in the kernel for the full timeout.
    """
    if fcntl is None:
        yield False
        return
    try:
        root.mkdir(parents=True, exist_ok=True)
        fh = open(root / LOCKFILE, "a+")
    except OSError:
        yield False
        return
    got = False
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
                got = True
                break
            except OSError:
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.02)
        yield got
    finally:
        if got:
            try:
                fcntl.flock(fh, fcntl.LOCK_UN)
            except OSError:
                pass
        fh.close()


# ---------------------------------------------------------------------------
# SharedBlobs: the content-addressed payload layer
# ---------------------------------------------------------------------------

class SharedBlobs:
    """One blob per sha256 under ``<root>/blobs/``, shared by N manifests.

    A blob's filename *is* its content address, so equality of name and
    content hash is the integrity invariant: a file not matching its name
    is garbage for every referencing manifest and may be unlinked by
    anyone (the stores' corruption recovery does exactly that, then
    rebuilds and re-adds a good copy).
    """

    #: seconds to wait per manifest flock during :meth:`gc`
    lock_timeout: float = 2.0

    def __init__(self, root):
        self.root = Path(root)

    @property
    def blob_dir(self) -> Path:
        return self.root / BLOBS_DIR

    def path(self, sha: str) -> Path:
        return self.blob_dir / sha

    def store_root(self, subdir: str) -> Path:
        """The manifest root a store should use under this shared layout."""
        return self.root / subdir

    def add(self, blob: bytes, sha: Optional[str] = None) -> str:
        """Admit content; returns its sha256 (the payload ref suffix).

        Deduplicates by existence — but a dedup hit refreshes the blob's
        mtime so the GC grace window re-covers the caller's gap between
        this call and its manifest commit.
        """
        sha = sha or hashlib.sha256(blob).hexdigest()
        dst = self.path(sha)
        if dst.exists():
            try:
                os.utime(dst)
            except OSError:
                pass
            return sha
        self.blob_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.blob_dir / f".{sha}.tmp-{os.getpid()}"
        tmp.write_bytes(blob)
        os.replace(tmp, dst)
        return sha

    def read(self, sha: str) -> bytes:
        return self.path(sha).read_bytes()

    # -- refcounting + reclamation ----------------------------------------

    def manifest_dirs(self) -> List[Path]:
        """Store roots under this layout, in sorted (= lock) order."""
        if not self.root.is_dir():
            return []
        return sorted(
            d for d in self.root.iterdir()
            if d.is_dir() and d.name != BLOBS_DIR
            and ((d / MANIFEST).exists() or (d / LOCKFILE).exists()))

    def refcounts(self) -> Dict[str, int]:
        """sha256 → number of live manifest entries referencing it."""
        refs: Dict[str, int] = {}
        for d in self.manifest_dirs():
            for sha in self._manifest_refs(d):
                refs[sha] = refs.get(sha, 0) + 1
        return refs

    @staticmethod
    def _manifest_refs(store_root: Path) -> List[str]:
        try:
            data = json.loads((store_root / MANIFEST).read_text())
            if data.get("schema") != SCHEMA_VERSION:
                return []
            entries = data["entries"]
        except Exception:
            # unparseable manifest: its store restarts empty on next load
            # (move-aside recovery), so these refs are already lost to
            # their owner — contributing none cannot strand a live entry
            return []
        out = []
        for ent in entries.values():
            payload = str(ent.get("payload", ""))
            if payload.startswith(BLOB_PREFIX):
                out.append(payload[len(BLOB_PREFIX):])
        return out

    def gc(self, grace_s: float = 3600.0) -> List[str]:
        """Unlink blobs no manifest references.  Returns removed names.

        Holds every manifest flock (sorted order — the same order every
        sweeper uses, so two concurrent gcs cannot deadlock) across both
        the ref scan and the unlinks; see the module docstring for the
        full safety argument.
        """
        removed: List[str] = []
        with contextlib.ExitStack() as stack:
            for d in self.manifest_dirs():
                stack.enter_context(_dir_flock(d, self.lock_timeout))
            refs = self.refcounts()
            if not self.blob_dir.is_dir():
                return removed
            now = time.time()
            for f in sorted(self.blob_dir.iterdir()):
                if f.name in refs:
                    continue
                try:
                    if now - f.stat().st_mtime < grace_s:
                        continue        # possibly mid-publish: spare it
                    f.unlink()
                    removed.append(f.name)
                except OSError:
                    pass
        return removed

    def verify(self) -> dict:
        """Integrity report: {"ok", "corrupt", "dangling", "unreferenced"}.

        ``corrupt`` = blobs whose content hash mismatches their name;
        ``dangling`` = manifest refs with no blob on disk (the referencing
        store will miss and rebuild); ``unreferenced`` = gc candidates.
        """
        refs = self.refcounts()
        ok, corrupt, unref = [], [], []
        present = set()
        if self.blob_dir.is_dir():
            for f in sorted(self.blob_dir.iterdir()):
                if f.name.startswith("."):
                    continue
                present.add(f.name)
                try:
                    good = hashlib.sha256(
                        f.read_bytes()).hexdigest() == f.name
                except OSError:
                    good = False
                if not good:
                    corrupt.append(f.name)
                elif f.name in refs:
                    ok.append(f.name)
                else:
                    unref.append(f.name)
        dangling = sorted(set(refs) - present)
        return {"ok": ok, "corrupt": corrupt, "dangling": dangling,
                "unreferenced": unref}

    def summary(self) -> dict:
        refs = self.refcounts()
        blobs = ([f for f in self.blob_dir.iterdir()
                  if not f.name.startswith(".")]
                 if self.blob_dir.is_dir() else [])
        return dict(blobs=len(blobs),
                    bytes=sum(f.stat().st_size for f in blobs),
                    refs=sum(refs.values()),
                    stores=len(self.manifest_dirs()))


# ---------------------------------------------------------------------------
# StoreBase: the manifest discipline PlanStore/ExecStore share
# ---------------------------------------------------------------------------

class StoreBase:
    """Manifest + flock + LRU machinery common to the two durable stores.

    Subclasses set :attr:`payload_dir_name` / :attr:`payload_suffix` and
    keep their own ``get``/``put``/``verify`` (payload formats, integrity
    semantics and stats differ); everything below — locking, manifest
    load/write, entry drops, byte-budget gc, clear — is identical by
    construction instead of by parallel maintenance.  ``stats`` is the
    subclass's dataclass; this base only touches its ``corrupt`` and
    ``evicted`` counters, which both declare.

    With ``shared`` set (a :class:`SharedBlobs`), payloads are admitted
    to the content-addressed layout and manifest entries hold
    ``blob:<sha256>`` refs; without it, payloads live under the store's
    own payload directory exactly as before.
    """

    payload_dir_name: str = "payloads"
    payload_suffix: str = ""
    #: seconds to wait for the cross-process manifest lock before falling
    #: through to an unmerged (in-memory-view) write
    lock_timeout: float = 2.0

    def __init__(self, root, byte_budget: Optional[int], stats,
                 shared: Optional[SharedBlobs] = None):
        self.root = Path(root)
        self.byte_budget = byte_budget
        self.stats = stats
        self.shared = shared
        self._entries: Optional[Dict[str, dict]] = None   # lazy manifest
        self._lock = threading.Lock()

    # -- locking (flock OUTER, self._lock inner — same order everywhere) --

    def _manifest_flock(self, timeout: Optional[float] = None):
        """Cross-process manifest lock; yields True when acquired — the
        caller must then drop its cached view (``self._entries = None``)
        so the merge sees entries committed by other processes.  Lock
        order is flock OUTER, ``self._lock`` inner, everywhere."""
        return _dir_flock(self.root,
                          self.lock_timeout if timeout is None else timeout)

    # -- manifest ----------------------------------------------------------

    @property
    def _payload_dir(self) -> Path:
        return self.root / self.payload_dir_name

    def _manifest_path(self) -> Path:
        return self.root / MANIFEST

    def _load_manifest_locked(self) -> Dict[str, dict]:
        """Lazy manifest read; anything unusable is moved aside, not fatal."""
        if self._entries is not None:
            return self._entries
        path = self._manifest_path()
        entries: Dict[str, dict] = {}
        try:
            data = json.loads(path.read_text())
            if data.get("schema") != SCHEMA_VERSION:
                raise ValueError(f"manifest schema {data.get('schema')!r} "
                                 f"!= {SCHEMA_VERSION}")
            entries = dict(data["entries"])
        except FileNotFoundError:
            pass
        except Exception:
            # corrupt json / wrong schema / wrong shape: move aside and
            # restart empty — never crash a running job over stale state
            self.stats.corrupt += 1
            try:
                path.replace(path.with_suffix(".corrupt"))
            except OSError:
                pass
        self._entries = entries
        return entries

    def _write_manifest_locked(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        payload = json.dumps({"schema": SCHEMA_VERSION,
                              "entries": self._entries or {}},
                             sort_keys=True, indent=1)
        tmp = self._manifest_path().with_name(
            f".{MANIFEST}.tmp-{os.getpid()}")
        tmp.write_text(payload)
        os.replace(tmp, self._manifest_path())

    # -- payload placement -------------------------------------------------

    def _blob_path(self, sha: str) -> Path:
        if self.shared is not None:
            return self.shared.path(sha)
        # a store opened directly on a shared sub-root (the CLI does this)
        # resolves refs against the sibling blobs/ directory
        return self.root.parent / BLOBS_DIR / sha

    def _payload_path(self, ent: dict) -> Path:
        name = str(ent["payload"])
        if name.startswith(BLOB_PREFIX):
            return self._blob_path(name[len(BLOB_PREFIX):])
        return self._payload_dir / name

    def _persist_payload_locked(self, key: str, blob: bytes,
                                sha: str) -> str:
        """Write payload bytes; returns the manifest ``payload`` ref."""
        if self.shared is not None:
            self.shared.add(blob, sha)
            return BLOB_PREFIX + sha
        self._payload_dir.mkdir(parents=True, exist_ok=True)
        name = f"{key}{self.payload_suffix}"
        tmp = self._payload_dir / f".{name}.tmp-{os.getpid()}"
        tmp.write_bytes(blob)
        os.replace(tmp, self._payload_dir / name)
        return name

    def _drop_locked(self, key: str) -> None:
        ent = (self._entries or {}).pop(key, None)
        if ent is None:
            return
        if str(ent["payload"]).startswith(BLOB_PREFIX):
            # dropping a *ref* never unlinks the blob — another manifest
            # may reference it; SharedBlobs.gc reclaims refcount-0 blobs
            return
        try:
            (self._payload_dir / ent["payload"]).unlink()
        except OSError:
            pass

    def _discard_corrupt_payload(self, ent: dict) -> None:
        """Unlink a blob whose content provably mismatches its address.

        Only for ``blob:`` refs (local payloads are unlinked by
        ``_drop_locked``): the name *is* the content hash, so a mismatch
        is garbage for every referencing manifest, and removing it lets
        the rebuild path re-``add`` a good copy under the same name
        (``add`` deduplicates by existence and must not trust a corrupt
        survivor).
        """
        name = str(ent.get("payload", ""))
        if not name.startswith(BLOB_PREFIX):
            return
        sha = name[len(BLOB_PREFIX):]
        path = self._blob_path(sha)
        try:
            if hashlib.sha256(path.read_bytes()).hexdigest() != sha:
                path.unlink()
        except OSError:
            pass

    # -- shared core API ---------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._load_manifest_locked())

    # -- maintenance -------------------------------------------------------

    def _gc_locked(self, byte_budget: Optional[int],
                   sweep: bool = False) -> List[str]:
        entries = self._load_manifest_locked()
        evicted: List[str] = []
        if byte_budget is not None:
            total = sum(int(e["bytes"]) for e in entries.values())
            for key, _ in sorted(entries.items(),
                                 key=lambda kv: kv[1]["last_used"]):
                if total <= byte_budget:
                    break
                total -= int(entries[key]["bytes"])
                self._drop_locked(key)
                evicted.append(key)
        # the orphan sweep runs only from explicit maintenance (gc()/
        # verify(prune)/clear()), never from write-through puts: a put-time
        # sweep against a stale manifest view would delete payloads (and
        # in-flight temp files) that a *concurrent* writer owns
        if sweep and self._payload_dir.is_dir():
            owned = {e["payload"] for e in entries.values()}
            now = time.time()
            for f in self._payload_dir.iterdir():
                if f.name in owned:
                    continue
                try:
                    # leave recent temp files alone — they may be another
                    # process's write between tmp-write and os.replace
                    if f.name.startswith(".") and \
                            now - f.stat().st_mtime < 3600:
                        continue
                    f.unlink()
                except OSError:
                    pass
        self.stats.evicted += len(evicted)
        return evicted

    def gc(self, byte_budget: Optional[int] = None) -> List[str]:
        """Evict LRU entries beyond the byte budget; sweep orphan files."""
        with self._manifest_flock():
            with self._lock:
                # re-read the manifest so the sweep sees entries committed
                # by other processes since ours was loaded (done locked or
                # not: maintenance always acts on the freshest view)
                self._entries = None
                evicted = self._gc_locked(
                    self.byte_budget if byte_budget is None
                    else byte_budget, sweep=True)
                self._write_manifest_locked()
        return evicted

    def clear(self) -> None:
        with self._manifest_flock():
            with self._lock:
                self._entries = None    # clear the freshest on-disk view
                self._load_manifest_locked()
                for key in list(self._entries or {}):
                    self._drop_locked(key)
                self._gc_locked(0, sweep=True)
                self._write_manifest_locked()

    def _orphans(self, entries: Dict[str, dict]) -> List[str]:
        owned = {e["payload"] for e in entries.values()}
        return ([f.name for f in self._payload_dir.iterdir()
                 if f.name not in owned]
                if self._payload_dir.is_dir() else [])


# ---------------------------------------------------------------------------
# CLI: ls / verify / gc over a whole shared layout
# ---------------------------------------------------------------------------

def _cli_ls(blobs: SharedBlobs) -> int:
    refs = blobs.refcounts()
    names = (sorted(f.name for f in blobs.blob_dir.iterdir()
                    if not f.name.startswith("."))
             if blobs.blob_dir.is_dir() else [])
    if not names and not refs:
        print(f"shared store {blobs.root}: empty")
        return 0
    total = 0
    print(f"{'sha256':<34} {'kB':>9} {'refs':>5}")
    for name in names:
        size = blobs.path(name).stat().st_size
        total += size
        print(f"{name[:32]:<34} {size / 1e3:>9.1f} {refs.get(name, 0):>5}")
    stores = ", ".join(d.name for d in blobs.manifest_dirs()) or "none"
    print(f"total: {len(names)} blobs, {total / 1e6:.2f} MB, "
          f"{sum(refs.values())} refs (stores: {stores})")
    return 0


def _cli_verify(blobs: SharedBlobs) -> int:
    report = blobs.verify()
    print(f"shared store {blobs.root}: {len(report['ok'])} ok, "
          f"{len(report['corrupt'])} corrupt, "
          f"{len(report['dangling'])} dangling refs, "
          f"{len(report['unreferenced'])} unreferenced")
    for name in report["corrupt"]:
        print(f"  corrupt:      {name}")
    for name in report["dangling"]:
        print(f"  dangling:     {name}")
    for name in report["unreferenced"]:
        print(f"  unreferenced: {name}")
    return 1 if report["corrupt"] else 0


def _cli_gc(blobs: SharedBlobs, grace_s: float) -> int:
    removed = blobs.gc(grace_s=grace_s)
    print(f"shared store {blobs.root}: removed {len(removed)} "
          f"unreferenced blobs → {blobs.summary()['bytes'] / 1e6:.2f} MB")
    for name in removed:
        print(f"  removed: {name}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.shared_store",
        description="Inspect and maintain a content-addressed fleet store.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ls = sub.add_parser("ls", help="list blobs with refcounts")
    p_ls.add_argument("root", help="shared store root")
    p_v = sub.add_parser("verify", help="check blob integrity + refs")
    p_v.add_argument("root", help="shared store root")
    p_gc = sub.add_parser("gc", help="remove unreferenced blobs")
    p_gc.add_argument("root", help="shared store root")
    p_gc.add_argument("--grace-s", type=float, default=3600.0,
                      help="spare blobs younger than this many seconds")
    args = ap.parse_args(argv)
    blobs = SharedBlobs(args.root)
    if args.cmd == "ls":
        return _cli_ls(blobs)
    if args.cmd == "verify":
        return _cli_verify(blobs)
    return _cli_gc(blobs, args.grace_s)


if __name__ == "__main__":
    raise SystemExit(main())
