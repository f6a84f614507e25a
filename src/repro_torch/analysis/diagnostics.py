"""Diagnostic and suppression model for reaplint.

Port of ``repro.analysis.diagnostics``, copied so that the port's linter
and the reference's read the same suppression comments.

Ruff-style diagnostics (``path:line:col: REAP00x message``) plus the
``# reaplint: disable=REAP00x <reason>`` suppression comment the checker
honours and *counts* — a suppression is an audited exception to the REAP
contract, never a silent one, so the reason text is mandatory: a
suppression without one is ignored and the diagnostic stands.

Everything here is stdlib-only so ``python -m repro_torch.analysis`` runs
in a bare interpreter (no torch, no numpy).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

# codes must stay in sync with rules.RULES; REAP000 is reserved for files
# the checker itself cannot parse
RULE_CODES = ("REAP001", "REAP002", "REAP003", "REAP004")
PARSE_ERROR_CODE = "REAP000"

_SUPPRESS_RE = re.compile(
    r"#\s*reaplint:\s*disable=([A-Za-z0-9,]+)(?:\s+(.*?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding, anchored to a source location."""

    code: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tail = f"  [suppressed: {self.suppress_reason}]" \
            if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} {self.message}{tail}")


@dataclasses.dataclass(frozen=True)
class Suppression:
    codes: Tuple[str, ...]
    reason: str
    line: int

    @property
    def valid(self) -> bool:
        return bool(self.reason)

    def covers(self, code: str) -> bool:
        return self.valid and code in self.codes


def scan_suppressions(lines: List[str]) -> Dict[int, Suppression]:
    """Map 1-based line number → suppression declared on that line."""
    out: Dict[int, Suppression] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        codes = tuple(c.strip().upper() for c in m.group(1).split(",")
                      if c.strip())
        out[i] = Suppression(codes, (m.group(2) or "").strip(), i)
    return out


def suppression_for(supps: Dict[int, Suppression], lines: List[str],
                    line: int) -> Optional[Suppression]:
    """Suppression applying to a diagnostic at ``line``: same line, or a
    contiguous block of comment-only lines directly above (so a reason
    may wrap over several comment lines)."""
    if line in supps:
        return supps[line]
    prev = line - 1
    while prev >= 1 and lines[prev - 1].lstrip().startswith("#"):
        if prev in supps:
            return supps[prev]
        prev -= 1
    return None


class Report:
    """All diagnostics from one checker run, with summary accounting."""

    def __init__(self, diagnostics: List[Diagnostic], files: int):
        self.diagnostics = sorted(
            diagnostics, key=lambda d: (d.path, d.line, d.col, d.code))
        self.files = files

    @property
    def violations(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if not d.suppressed]

    @property
    def suppressed(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.suppressed]

    @property
    def ok(self) -> bool:
        return not self.violations

    def counts(self) -> Dict[str, Dict[str, int]]:
        per: Dict[str, Dict[str, int]] = {}
        for d in self.diagnostics:
            rec = per.setdefault(d.code, dict(violations=0, suppressed=0))
            rec["suppressed" if d.suppressed else "violations"] += 1
        return per

    def summary(self) -> dict:
        return dict(files=self.files,
                    total_violations=len(self.violations),
                    total_suppressions=len(self.suppressed),
                    per_rule=self.counts(), ok=self.ok)

    def format_text(self, show_suppressed: bool = False) -> str:
        shown = self.diagnostics if show_suppressed else self.violations
        lines = [d.format() for d in shown]
        per = ", ".join(
            f"{code} v={rec['violations']} s={rec['suppressed']}"
            for code, rec in sorted(self.counts().items()))
        lines.append(
            f"reaplint: {self.files} files, {len(self.violations)} "
            f"violations, {len(self.suppressed)} suppressed"
            + (f" ({per})" if per else ""))
        return "\n".join(lines)
