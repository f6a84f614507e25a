"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (``BENCHMARK.json``).  Without them it prints no result and exits 2.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared beside its limit); the
last lines of standard error repeat the checks.  Set-up's split goes to
standard error before them.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the CUDA driver's cache at a fixed place inside the checkout (the kernels
# build into build/repro_torch_kernels there already)
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))

if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)             # bench/'s folders are not top-level modules
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from bench import harness
    return harness.main(parse_args(argv), T0)


if __name__ == "__main__":
    sys.exit(main())
