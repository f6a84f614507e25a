"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; the
helpers they share are in ``csrc/common.cuh``.  It is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/<name>-<digest>.so`` at the
root of the checkout, where ``<digest>`` (``source_digest``) covers the
source, the shared headers and the flags, so an edited source rebuilds and
an unchanged one is reused.  ``-Xptxas -v`` reports (registers, shared
memory, spills) are kept beside each library.

When an exec cache is in effect (``runtime.exec_store``), ``load`` resolves
through it instead: memory, then the kernel-library store, then an ``nvcc``
build that is admitted to the store.  The store's bytes are digest-checked
before they reach ``dlopen``.

A failed build raises; nothing falls back to a kernel's plain version.
``refuse_grad`` is the one guard of the kernels that have no backward kernel
(K1-K3: the reference trains nothing through them): a CUDA call that would
have to give a gradient raises.
Nothing here runs at import: this module is imported on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}

#: opens a shared library by path (``ctypes.CDLL``; a test may substitute a
#: fake, as it substitutes the compiler through ``_nvcc``)
dlopen = ctypes.CDLL


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build id), or
    ``"not found"`` where there is no ``nvcc``."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "not found"
    lines = out.strip().splitlines()
    return lines[-1].strip() if lines else "not found"


def source_digest(name: str) -> str:
    """Digest of what ``csrc/<name>.cu`` builds from: the source, the shared
    headers and the flags."""
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to with no exec cache in effect."""
    return BUILD_DIR / f"{name}-{source_digest(name)}.so"


def _compile(outputs: Dict[str, Path]) -> None:
    """Run ``nvcc`` for every ``name → output path``, all processes started
    together; each log lands beside its output.  Raises if any failed."""
    procs = {}
    for name, out in outputs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build(*names: str) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together; returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    _compile({n: p for n, p in paths.items() if not p.exists()})
    return paths


def compile_libraries(names: Iterable[str]) -> Dict[str, bytes]:
    """Run ``nvcc`` for every named kernel (built or not), all processes
    started together, in a scratch directory under ``BUILD_DIR``; returns
    each library's bytes.  The exec cache's build step."""
    stage = BUILD_DIR / "stage"
    stage.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=stage) as tmp:
        outputs = {n: Path(tmp) / f"{n}.so" for n in dict.fromkeys(names)}
        _compile(outputs)
        return {n: p.read_bytes() for n, p in outputs.items()}


def open_library(name: str, blob: bytes):
    """``dlopen`` a library from bytes the caller has checked: written to a
    scratch file under ``BUILD_DIR``, opened, and unlinked (the mapping
    outlives the file)."""
    stage = BUILD_DIR / "stage"
    stage.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix=f"{name}-", suffix=".so", dir=stage)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(blob)
        return dlopen(path)
    finally:
        os.unlink(path)


def build_log(name: str) -> str:
    """The ``nvcc`` output (ptxas register/shared-memory/spill lines) of the
    current build of ``name``; empty if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``: through the exec cache in
    effect, or else built (if needed) under ``BUILD_DIR`` and memoized per
    process."""
    from ..runtime.exec_store import current_exec_cache
    cache = current_exec_cache()
    if cache is not None:
        return cache.load(name)
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = dlopen(str(build(name)[name]))
            _LOADED[name] = lib
        return lib


def load_all(*names: str) -> Dict[str, ctypes.CDLL]:
    """``load`` for several kernels, the missing ones built together."""
    from ..runtime.exec_store import current_exec_cache
    cache = current_exec_cache()
    if cache is not None:
        return cache.load_many(names)
    build(*names)
    return {n: load(n) for n in names}


def bind(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """``load(name)`` with the C signature of its launch function ``entry``
    declared (it returns a CUDA error code, 0 on success)."""
    lib = load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:     # without argtypes ctypes cuts pointers to int
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise ``RuntimeError`` with CUDA's message if a launch failed."""
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` if a CUDA call of ``kernel``, which has
    no backward kernel, is asked for a gradient: grad mode is on and an
    input requires grad.  Without this the call would return a result with
    no gradient and nothing would say so.  (On the CPU the plain versions
    differentiate; they do not call this.)"""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel: it cannot give a gradient on "
            "the card (call it under torch.no_grad(), or on CPU tensors, "
            "whose plain version differentiates)")
