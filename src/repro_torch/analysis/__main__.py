"""CLI: ``python -m repro_torch.analysis --check src/repro_torch
[--summary out.json] [--purity [--device cpu]] [--show-suppressed]``.

Port of ``python -m repro.analysis``.  Exit status is 0 iff no unsuppressed
violations (and, with ``--purity``, every registered op replays to a
bit-identical plan).  ``--summary`` writes the counts as JSON, with the
reference's keys, so the suppression count is visible per run, not just
pass/fail.  The lint itself imports no torch and no numpy; ``--purity``
builds plans on ``--device`` (``cuda`` unless ``cpu`` is asked for).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .checker import check_paths


def default_paths() -> list:
    """``src/repro_torch`` from the repo root, else the installed package."""
    if Path("src/repro_torch").is_dir():
        return ["src/repro_torch"]
    return [str(Path(__file__).resolve().parents[1])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reaplint: REAP plan-contract checker (REAP001-004) "
                    "for the PyTorch port")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--check", nargs="+", default=None, metavar="PATH",
                    help="explicit lint targets (same as positional)")
    ap.add_argument("--summary", metavar="FILE",
                    help="write a JSON summary (violations/suppressions)")
    ap.add_argument("--purity", action="store_true",
                    help="also run the dynamic purity harness over every "
                         "registered op (requires torch/numpy)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where --purity builds its plans (default cuda)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="print suppressed diagnostics too")
    args = ap.parse_args(argv)
    if args.device is not None and not args.purity:
        ap.error("--device applies to --purity only")

    paths = list(args.check or []) + list(args.paths)
    if not paths and not args.purity:
        paths = default_paths()

    ok = True
    summary = {}
    if paths:
        report = check_paths(paths)
        print(report.format_text(show_suppressed=args.show_suppressed))
        summary = report.summary()
        ok = report.ok

    if args.purity:
        from .purity_check import run_purity_checks
        results = run_purity_checks(device=args.device or "cuda")
        for tag, res in sorted(results.items()):
            state = "PASS" if res["ok"] else f"FAIL ({res['detail']})"
            print(f"reaplint purity: {tag}: {state}")
        summary["purity"] = {t: r["ok"] for t, r in results.items()}
        ok = ok and all(r["ok"] for r in results.values())

    if args.summary:
        Path(args.summary).write_text(json.dumps(summary, indent=2,
                                                 sort_keys=True) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
