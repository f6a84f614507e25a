"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; the
helpers they share are in ``csrc/common.cuh``.  It is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/<name>-<digest>.so`` at the
root of the checkout, where ``<digest>`` covers the source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one is
reused.  ``-Xptxas -v`` reports
(registers, shared memory, spills) are kept beside each library.

A failed build raises; nothing falls back to a kernel's plain version.
Nothing here runs at import: this module is imported on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (digest of the source, the shared
    headers and the flags)."""
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together; returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
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
    return paths


def build_log(name: str) -> str:
    """The ``nvcc`` output (ptxas register/shared-memory/spill lines) of the
    current build of ``name``; empty if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; memoized per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            _LOADED[name] = lib
        return lib


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
