"""A stand-in for ``nvcc`` and ``dlopen`` in ``repro_torch.kernels._build``,
so the kernel-library store's tests run on a machine with neither: the fake
compiler writes bytes derived from the kernel's source, and the fake
``dlopen`` records every blob it is handed and refuses anything the fake
compiler did not write (a corrupt payload that reached it fails the test).
Imports only ``_build``, so a child process loads it quickly."""
import sys
from pathlib import Path

from repro_torch.kernels import _build

KERNELS = ("bsr_spgemm", "bsr_spmm", "block_sparse_attention",
           "flash_attention", "moe_gemm", "rwkv6_scan")
MAGIC = b"FAKE-SO\0"

# ``--version`` prints a release line; otherwise it writes ``-o``'s file
# from the source's name and bytes (so libraries differ in size and
# content), and exits 1 for the kernel named in FAKE_NVCC_FAIL.
FAKE_NVCC = """\
import hashlib, os, sys
from pathlib import Path
args = sys.argv[1:]
if args == ["--version"]:
    print("fake nvcc\\nCuda compilation tools, release 0.0, fake-1")
    sys.exit(0)
src = Path(args[-1])
if os.environ.get("FAKE_NVCC_FAIL") == src.stem:
    print("fake nvcc: error in", src.name)
    sys.exit(1)
body = src.read_bytes()
Path(args[args.index("-o") + 1]).write_bytes(
    b"FAKE-SO\\0" + src.stem.encode() + b"\\0"
    + hashlib.sha256(body).digest() + body[: 64 * len(src.stem)])
print("ptxas info    : fake", src.name)
"""


class FakeLib:
    """What the fake ``dlopen`` returns: the library's bytes and name."""

    def __init__(self, blob: bytes):
        self.blob = blob
        self.name = blob.split(b"\0")[1].decode()


def good(blob: bytes) -> bool:
    return blob.startswith(MAGIC)


def install(monkeypatch, root: Path) -> list:
    """Fake ``nvcc`` and ``dlopen`` in ``_build`` and a private
    ``BUILD_DIR`` under ``root`` (through ``monkeypatch.setattr``); returns
    the list of blobs ``dlopen`` is handed."""
    script = root / "fake_nvcc.py"
    script.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    script.chmod(0o755)
    opened = []

    def fake_dlopen(path):
        blob = Path(path).read_bytes()
        opened.append(blob)
        if not good(blob):
            raise OSError(f"{path}: invalid ELF header")
        return FakeLib(blob)

    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "dlopen", fake_dlopen)
    monkeypatch.setattr(_build, "BUILD_DIR", root / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    return opened
