"""reaplint checker: parse → collect facts → run rules → apply suppressions.

Port of ``repro.analysis.checker``.  Stdlib-only by construction: the
OpSpec contract metadata is loaded from the port's ``runtime/ops.py`` *by
file path* (that module imports nothing beyond the stdlib), so
``python -m repro_torch.analysis --check src/repro_torch`` runs in a bare
interpreter — no torch, no numpy.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Set, Tuple

from . import rules as _rules
from .diagnostics import (PARSE_ERROR_CODE, Diagnostic, Report,
                          scan_suppressions, suppression_for)

_OPS_META = None


def load_ops_metadata():
    """The OpSpec contract tables, loaded standalone from runtime/ops.py.

    A plain ``import repro_torch.runtime.ops`` would execute
    ``repro_torch/runtime/__init__.py`` and with it torch; loading the
    single file keeps the linter dependency-free.
    """
    global _OPS_META
    if _OPS_META is None:
        path = Path(__file__).resolve().parents[1] / "runtime" / "ops.py"
        spec = importlib.util.spec_from_file_location(
            "_reaplint_torch_ops_metadata", path)
        mod = importlib.util.module_from_spec(spec)
        # dataclasses resolves cls.__module__ through sys.modules, so the
        # standalone module must be registered before executing
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _OPS_META = mod
    return _OPS_META


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST
    name: str
    roles: Set[str]


class ParsedFile:
    """One source file with everything the rules need precomputed."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.suppressions = scan_suppressions(self.lines)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # OpSpec(...) construction sites (kwarg name → value node)
        self.opspec_calls: List[Tuple[ast.Call, Dict[str, ast.AST]]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) \
                    and _rules.attr_tail(node.func) == "OpSpec":
                kwargs = {kw.arg: kw.value for kw in node.keywords
                          if kw.arg is not None}
                self.opspec_calls.append((node, kwargs))
        self.functions = self._scan_functions()

    def _scan_functions(self) -> List[FuncInfo]:
        meta = load_ops_metadata()
        # functions bound to OpSpec hooks get the hook's role even when
        # their name says nothing (e.g. prepare=_prepare_moe_dispatch)
        bound_roles: Dict[str, Set[str]] = {}
        for _, kwargs in self.opspec_calls:
            for hook, value in kwargs.items():
                if not isinstance(value, ast.Name):
                    continue
                if hook in meta.INSPECTOR_HOOKS:
                    bound_roles.setdefault(value.id, set()).add("inspector")
                elif hook in meta.EXECUTOR_HOOKS:
                    bound_roles.setdefault(value.id, set()).add("executor")
        out: List[FuncInfo] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            roles: Set[str] = set(bound_roles.get(node.name, ()))
            if _rules.INSPECT_NAME_RE.search(node.name):
                roles.add("inspector")
            if _rules.EXEC_NAME_RE.search(node.name):
                roles.add("executor")
            # decode hot loops in sync-scoped modules (the serve scheduler)
            # carry the executor sync-hygiene contract (REAP003)
            p = self.path.replace("\\", "/")
            if any(p.endswith(m) for m in _rules.SYNC_SCOPE_MODULES) \
                    and _rules.HOT_LOOP_NAME_RE.search(node.name):
                roles.add("executor")
            if roles:
                out.append(FuncInfo(node, node.name, roles))
        return out


@dataclasses.dataclass
class Facts:
    """Cross-file knowledge the rules consult."""

    op_tags: Set[str] = dataclasses.field(default_factory=set)
    dataclass_names: Set[str] = dataclasses.field(default_factory=set)


def _collect_facts(files: List[ParsedFile]) -> Facts:
    facts = Facts()
    for pf in files:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if _rules.attr_tail(target) == "dataclass":
                        facts.dataclass_names.add(node.name)
        for _, kwargs in pf.opspec_calls:
            tag = _rules.const_str(kwargs.get("tag"))
            if tag:
                facts.op_tags.add(tag)
            fops = kwargs.get("fingerprint_ops")
            if isinstance(fops, (ast.Tuple, ast.List)):
                for el in fops.elts:
                    s = _rules.const_str(el)
                    if s:
                        facts.op_tags.add(s)
    return facts


class ReaplintChecker:
    """Run every REAP00x rule over a set of sources."""

    def __init__(self, meta=None):
        self.meta = meta or load_ops_metadata()

    def check_sources(
            self, sources: Iterable[Tuple[str, str]]) -> Report:
        diags: List[Diagnostic] = []
        files: List[ParsedFile] = []
        n = 0
        for path, text in sources:
            n += 1
            try:
                files.append(ParsedFile(path, text))
            except SyntaxError as exc:
                diags.append(Diagnostic(
                    PARSE_ERROR_CODE, path, exc.lineno or 1,
                    (exc.offset or 0) + 1, f"cannot parse: {exc.msg}"))
        facts = _collect_facts(files)
        for pf in files:
            seen = set()
            for rule in _rules.RULES.values():
                for code, node, message in rule(pf, facts, self.meta):
                    line = getattr(node, "lineno", 1)
                    col = getattr(node, "col_offset", 0) + 1
                    key = (code, line, col, message)
                    if key in seen:
                        continue
                    seen.add(key)
                    diags.append(self._apply_suppression(
                        pf, code, line, col, message))
        return Report(diags, files=n)

    def _apply_suppression(self, pf: ParsedFile, code: str, line: int,
                           col: int, message: str) -> Diagnostic:
        supp = suppression_for(pf.suppressions, pf.lines, line)
        if supp is not None and code in supp.codes:
            if supp.valid:
                return Diagnostic(code, pf.path, line, col, message,
                                  suppressed=True,
                                  suppress_reason=supp.reason)
            message += " (suppression ignored: a reason is required)"
        return Diagnostic(code, pf.path, line, col, message)

    def check_paths(self, paths: Iterable) -> Report:
        sources = []
        for path in paths:
            p = Path(path)
            if p.is_dir():
                for f in sorted(p.rglob("*.py")):
                    sources.append((str(f), f.read_text()))
            else:
                sources.append((str(p), p.read_text()))
        return self.check_sources(sources)


def check_source(text: str, filename: str = "<string>",
                 meta=None) -> Report:
    """Lint one in-memory source (the fixture tests' entry point)."""
    return ReaplintChecker(meta).check_sources([(filename, text)])


def check_sources(sources: Iterable[Tuple[str, str]], meta=None) -> Report:
    return ReaplintChecker(meta).check_sources(sources)


def check_paths(paths: Iterable, meta=None) -> Report:
    return ReaplintChecker(meta).check_paths(paths)
