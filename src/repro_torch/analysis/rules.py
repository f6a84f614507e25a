"""The REAP00x rules: AST checks of the planned-op contract.

Port of ``repro.analysis.rules`` for the PyTorch executors.  REAP001 and
REAP002 are the reference's, read against the port's ``runtime/ops.py``.
REAP003 knows PyTorch's syncs instead of JAX's; REAP004 keeps the
reference's launch-shape rule, read in the port's terms (see below).

Scope model
-----------
Rules fire inside *contract scopes*, not everywhere:

* **inspector scope** — functions whose name matches ``inspect_* /
  fingerprint* / _fp_*`` or that are bound to an ``OpSpec`` hook in
  ``INSPECTOR_HOOKS`` (``fingerprint= / inspect= / prepare=``).
* **executor scope** — functions whose name contains an ``execute``
  segment or that are bound to a hook in ``EXECUTOR_HOOKS``
  (``execute_sync= / execute_chunked=``).

The hook lists, value/pattern attribute names, and required-hook set are
read from the port's ``runtime/ops.py`` itself (see
``checker.load_ops_metadata``), so this checker and
``OpSpec.__post_init__`` enforce one contract.

Rules
-----
REAP001  plan purity: inspector scope must not read value buffers
         (``.data`` / ``.values``), coerce operands with ``float()``, or
         take magnitudes (``abs``) — pattern attributes only.
REAP002  registry completeness: every non-router ``OpSpec`` declares the
         required hooks; ``plan_types`` entries are dataclasses the
         generic serializer can round-trip; the generic runtime modules
         (``runtime/{api,plan_cache,plan_store,exec_store,shard,
         shared_store}.py``) contain no op-tag string branches;
         run-stats keys used in those modules (``RunStats(key=...)``
         kwargs, ``stats["key"] = ...`` writes) are declared in
         ``ops.RUNSTATS_FIELDS`` — ad-hoc keys silently vanish from the
         typed surface.
REAP003  sync hygiene: executor scope must not call ``synchronize``
         (``torch.cuda.synchronize``, ``Event.synchronize``,
         ``Stream.synchronize``) anywhere; must not pull a device value to
         the host mid-body with ``.item()`` / ``.tolist()`` / ``.cpu()`` /
         ``.numpy()`` or ``np.asarray`` (return-boundary conversion is
         fine); and must not branch with Python ``if`` on a device value
         (a test that reads only metadata — ``.is_cuda``, ``.device``,
         ``.shape``, ``.dtype``, ``.ndim``, ``.numel()``, ``.size()``,
         ``.dim()``, ``torch.is_tensor`` — is fine).  Device values are
         the results of calls rooted at ``torch`` and of tensor moves
         (``.to(...)``, ``.cuda()``), and names assigned from them.
REAP004  shape discipline: executor launches must pass static shape kwargs
         through the pow-2 bucketing helpers (``next_pow2``,
         ``bucket_block_schedule``) or values derived from them (the
         ``*_cap`` / ``*_pad`` naming convention), never raw plan shapes.
         The port compiles nothing per shape (``nvcc`` builds each kernel
         library once), but its schedules must stay bit-identical to the
         reference's, and the bucketed extents are part of those
         schedules: a raw extent at a launch is where the port would leave
         the reference's plan.  The reference exempts ``jax.jit`` bodies
         (``is_jitted``); the port has none, so that exemption is dropped.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

# -- scope and convention tables ---------------------------------------------
INSPECT_NAME_RE = re.compile(r"^_?(inspect|fingerprint|fp)(_|$)")
EXEC_NAME_RE = re.compile(r"(^|_)execute(_|$)")
# helpers that make a shape "bucketed", and the naming convention for
# values derived from them (chunk caps, padded extents)
BUCKET_HELPERS = ("next_pow2", "bucket_block_schedule")
BUCKETED_NAME_RE = re.compile(r"(^|_)(cap|pad|pow2|bucket)(_|$|s$)")
# kwargs that size a device launch; raw (un-bucketed) values here leave
# the reference's bucketed schedule
STATIC_SHAPE_KWARGS = frozenset((
    "c_nnz", "c_cap", "n_out", "n_out_blocks", "num_segments",
    "n_j", "n_j_blocks", "bt", "n_slots"))
# reading *metadata of* a value buffer (a.data.dtype) is pattern, not value
META_OF_VALUE_ATTRS = ("dtype", "shape", "nbytes", "size", "ndim")
# generic runtime modules that must stay op-agnostic (REAP002c)
PROTECTED_TAG_MODULES = (
    "runtime/api.py", "runtime/plan_cache.py", "runtime/plan_store.py",
    "runtime/exec_store.py", "runtime/shard.py", "runtime/shared_store.py")
# variables that hold a per-run stats mapping (REAP002d: writes through
# them must use declared RUNSTATS_FIELDS keys)
STATS_NAME_RE = re.compile(r"(^|_)(stats?|st)(_|$)")
# the one non-field RunStats kwarg: the op-specific passthrough dict
RUNSTATS_EXTRA_KWARGS = ("extra",)
# calls rooted here produce device values; so do the tensor moves
SYNC_CALL_ROOTS = ("torch",)
DEVICE_MOVE_METHODS = ("to", "cuda")
# host/device syncs wherever they appear in executor scope
SYNC_ANYWHERE_METHODS = ("synchronize",)
# device → host pulls: allowed only inside a ``return`` expression.
# ``.cpu()`` / ``.numpy()`` exist on tensors only and fire on any receiver;
# ``.item()`` / ``.tolist()`` exist on numpy arrays too, so they fire on a
# device value only
PULL_ANY_METHODS = ("cpu", "numpy")
PULL_DEVICE_METHODS = ("item", "tolist")
# what an ``if`` may read of a device value without waiting for it
DEVICE_META_ATTRS = ("is_cuda", "device", "shape", "dtype", "ndim")
DEVICE_META_CALLS = ("numel", "is_tensor", "size", "dim")
# calls rooted at ``torch`` whose result is no tensor
NON_TENSOR_TORCH_CALLS = ("device", "is_available", "current_stream",
                          "Event", "Stream")
# modules whose decode-hot-loop functions carry the REAP003 sync-hygiene
# contract even though they are not OpSpec executors: the serve scheduler's
# step loop must not sync the device except the single audited token drain
# (suppressed inline with a reason)
SYNC_SCOPE_MODULES = ("launch/scheduler.py",)
HOT_LOOP_NAME_RE = re.compile(r"(^|_)(step|decode)(_|$)")


# -- small AST helpers --------------------------------------------------------

def func_root(func: ast.expr) -> Optional[str]:
    """Base name of a (possibly dotted) callee: ``a.b.c(...)`` → ``a``."""
    while isinstance(func, ast.Attribute):
        func = func.value
    return func.id if isinstance(func, ast.Name) else None


def attr_tail(func: ast.expr) -> Optional[str]:
    """Final name of a callee: ``a.b.c(...)`` → ``c``, ``f(...)`` → ``f``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def is_protected_module(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(p.endswith(m) for m in PROTECTED_TAG_MODULES)


# -- taint/bucket tracking (intraprocedural, fixed-point over assigns) --------

def _assigned_names(node) -> List[str]:
    out: List[str] = []
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                out.append(sub.id)
    return out


def _closure(fn_node: ast.AST, predicate) -> Set[str]:
    """Names assigned (directly or transitively) from expressions the
    ``predicate(expr, known)`` accepts.  Two passes reach a fixed point for
    the straight-line executor bodies this lints."""
    known: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn_node):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if value is not None and predicate(value, known):
                    known.update(_assigned_names(node))
    return known


def _is_device_call(call: ast.Call) -> bool:
    """A call whose result lives on the device: rooted at ``torch`` (but
    not one of its non-tensor helpers) or a tensor move."""
    tail = attr_tail(call.func)
    if func_root(call.func) in SYNC_CALL_ROOTS:
        return tail not in NON_TENSOR_TORCH_CALLS
    return isinstance(call.func, ast.Attribute) \
        and tail in DEVICE_MOVE_METHODS


def _expr_is_device(expr: ast.AST, known: Set[str]) -> bool:
    """Does this expression produce (or reference) a device value?

    Metadata reads (``x.shape``, ``x.is_cuda``, ``x.numel()``,
    ``torch.is_tensor(x)``, ...) are host values: their subtrees are not
    searched, as REAP001 exempts metadata of a value buffer."""
    stack = [expr]
    while stack:
        sub = stack.pop()
        if isinstance(sub, ast.Attribute) and sub.attr in DEVICE_META_ATTRS:
            continue
        if isinstance(sub, ast.Call):
            if attr_tail(sub.func) in DEVICE_META_CALLS:
                continue
            if _is_device_call(sub):
                return True
        if isinstance(sub, ast.Name) and sub.id in known:
            return True
        stack.extend(ast.iter_child_nodes(sub))
    return False


def _expr_is_bucketed(expr: ast.AST, known: Set[str]) -> bool:
    """Is a shape expression derived from the bucketing helpers (or pure
    constants)?  ``any``-semantics: one bucketed term marks the whole
    expression — a ``min(128, t_pad)`` clamp stays bucketed."""
    saw_nonconst = False
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and attr_tail(sub.func) in BUCKET_HELPERS:
            return True
        if isinstance(sub, ast.Name):
            saw_nonconst = True
            if sub.id in known or BUCKETED_NAME_RE.search(sub.id):
                return True
        elif isinstance(sub, ast.Attribute):
            saw_nonconst = True
            if BUCKETED_NAME_RE.search(sub.attr):
                return True
        elif isinstance(sub, ast.Constant):
            if isinstance(sub.value, str) \
                    and BUCKETED_NAME_RE.search(sub.value):
                return True      # sched["out_cap"]-style lookups
    return not saw_nonconst      # pure constants are compile-stable


def _in_return(parents: Dict[ast.AST, ast.AST], node: ast.AST) -> bool:
    cur = parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
        if isinstance(cur, ast.Return):
            return True
        cur = parents.get(cur)
    return False


# -- rule implementations -----------------------------------------------------
# Each rule returns raw findings as (code, anchor_node, message); the
# checker attaches locations and suppressions.

Finding = Tuple[str, ast.AST, str]


def rule_purity(pf, facts, meta) -> List[Finding]:
    """REAP001 — inspector scope is pattern-only."""
    out: List[Finding] = []
    for fn in pf.functions:
        if "inspector" not in fn.roles:
            continue
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.attr in meta.VALUE_ATTRS:
                parent = pf.parents.get(node)
                if isinstance(parent, ast.Attribute) \
                        and parent.attr in META_OF_VALUE_ATTRS:
                    continue
                out.append((
                    "REAP001", node,
                    f"inspector-scope function `{fn.name}` reads value "
                    f"buffer `.{node.attr}`; plans must be pattern-pure "
                    f"({'/'.join(meta.PATTERN_ATTRS[:4])}... only)"))
            elif isinstance(node, ast.Call):
                tail = attr_tail(node.func)
                if tail == "float":
                    out.append((
                        "REAP001", node,
                        f"`float()` coercion in inspector-scope function "
                        f"`{fn.name}` reads operand values"))
                elif tail == "abs":
                    out.append((
                        "REAP001", node,
                        f"magnitude test (`abs`) in inspector-scope "
                        f"function `{fn.name}` is value-dependent"))
    return out


def rule_registry(pf, facts, meta) -> List[Finding]:
    """REAP002 — registry contracts hold and generic modules stay generic."""
    out: List[Finding] = []
    for node, kwargs in pf.opspec_calls:
        if any(kw.arg is None for kw in node.keywords):
            continue                      # **splat: not statically checkable
        names = set(kwargs)
        tag = const_str(kwargs.get("tag")) or "<dynamic>"
        if meta.ROUTER_HOOK not in names:
            missing = [h for h in meta.REQUIRED_HOOKS if h not in names]
            if missing:
                out.append((
                    "REAP002", node,
                    f"OpSpec for op {tag!r} missing required hooks: "
                    f"{', '.join(missing)} (or declare "
                    f"{meta.ROUTER_HOOK}= to be a pure router)"))
        plan_types = kwargs.get("plan_types")
        if isinstance(plan_types, ast.Dict) \
                and not set(meta.SERIALIZER_HOOKS) <= names:
            for val in plan_types.values:
                cls = attr_tail(val)
                if cls is not None and cls not in facts.dataclass_names:
                    out.append((
                        "REAP002", val,
                        f"plan type `{cls}` of op {tag!r} is not a "
                        f"dataclass in the scanned tree; the generic "
                        f"serializer round-trips dataclasses only (or "
                        f"declare serialize=/deserialize=)"))
    if is_protected_module(pf.path):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Compare):
                for sub in ast.walk(node):
                    tag = const_str(sub)
                    if tag in facts.op_tags:
                        out.append((
                            "REAP002", sub,
                            f"op-tag string branch on {tag!r} in generic "
                            f"runtime module; dispatch belongs in the "
                            f"registry (register_op), not here"))
            elif isinstance(node, ast.Dict):
                for key in node.keys:
                    tag = const_str(key)
                    if tag in facts.op_tags:
                        out.append((
                            "REAP002", key,
                            f"op-tag dict dispatch on {tag!r} in generic "
                            f"runtime module; enumerate list_ops() "
                            f"instead"))
        out.extend(_runstats_fields(pf, meta))
    return out


def _runstats_fields(pf, meta) -> List[Finding]:
    """REAP002d — run-stats keys in protected modules are declared fields.

    ``RunStats`` is the typed per-run stats surface; its field list lives
    in ``ops.RUNSTATS_FIELDS`` so this check (stdlib-only) and the
    dataclass (jax-side) enforce one schema.  An undeclared
    ``RunStats(new_key=...)`` kwarg or ``stats["new_key"] = ...`` write in
    a generic runtime module means a stat consumers can never see through
    the typed API — declare the field instead.
    """
    declared = set(meta.RUNSTATS_FIELDS) | set(RUNSTATS_EXTRA_KWARGS)
    out: List[Finding] = []
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Call) \
                and attr_tail(node.func) == "RunStats":
            for kw in node.keywords:
                if kw.arg is not None and kw.arg not in declared:
                    out.append((
                        "REAP002", kw,
                        f"RunStats kwarg `{kw.arg}=` is not a declared "
                        f"field; add it to ops.RUNSTATS_FIELDS (and the "
                        f"dataclass) or route it through extra="))
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Subscript) \
                        and isinstance(target.value, ast.Name) \
                        and STATS_NAME_RE.search(target.value.id):
                    key = const_str(getattr(target, "slice", None))
                    if key is not None and key not in declared:
                        out.append((
                            "REAP002", target,
                            f"ad-hoc stats key {key!r} written through "
                            f"`{target.value.id}[...]` in generic runtime "
                            f"module; run-stats keys must be declared in "
                            f"ops.RUNSTATS_FIELDS"))
    return out


def _is_pull(node: ast.AST, device: Set[str]) -> bool:
    """``x.cpu()`` / ``x.numpy()`` on anything, ``x.item()`` /
    ``x.tolist()`` on a device value: a device → host copy."""
    if not isinstance(node, ast.Call) \
            or not isinstance(node.func, ast.Attribute):
        return False
    tail = node.func.attr
    if tail in PULL_ANY_METHODS:
        return True
    return tail in PULL_DEVICE_METHODS \
        and _expr_is_device(node.func.value, device)


def rule_sync(pf, facts, meta) -> List[Finding]:
    """REAP003 — executors never sync the device mid-body."""
    out: List[Finding] = []
    for fn in pf.functions:
        if "executor" not in fn.roles:
            continue
        device = _closure(fn.node, _expr_is_device)
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                tail = attr_tail(node.func)
                if tail in SYNC_ANYWHERE_METHODS:
                    out.append((
                        "REAP003", node,
                        f"`{tail}` in executor `{fn.name}` stalls the "
                        f"host/device overlap pipeline"))
                elif _is_pull(node, device) \
                        and not _is_pull(node.func.value, device) \
                        and not _in_return(pf.parents, node):
                    out.append((
                        "REAP003", node,
                        f"`.{tail}()` mid-body in executor `{fn.name}` "
                        f"copies a device value to the host (a hidden "
                        f"sync); convert once at the return boundary"))
                elif tail == "asarray" \
                        and func_root(node.func) in ("np", "numpy") \
                        and node.args \
                        and _expr_is_device(node.args[0], device) \
                        and not _in_return(pf.parents, node):
                    out.append((
                        "REAP003", node,
                        f"np.asarray of a device value mid-body in "
                        f"executor `{fn.name}` is a hidden sync; convert "
                        f"once at the return boundary"))
            elif isinstance(node, ast.If) \
                    and _expr_is_device(node.test, device):
                out.append((
                    "REAP003", node,
                    f"Python `if` on a device value in executor "
                    f"`{fn.name}` blocks on the result; hoist the "
                    f"decision into the plan"))
    return out


def rule_shapes(pf, facts, meta) -> List[Finding]:
    """REAP004 — launches size buffers with bucketed shapes only."""
    out: List[Finding] = []
    for fn in pf.functions:
        if "executor" not in fn.roles:
            continue
        bucketed = _closure(fn.node, _expr_is_bucketed)
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg in STATIC_SHAPE_KWARGS \
                        and not _expr_is_bucketed(kw.value, bucketed):
                    out.append((
                        "REAP004", kw.value,
                        f"executor `{fn.name}` launches with raw shape "
                        f"`{kw.arg}=`; route static shapes through "
                        f"{'/'.join(BUCKET_HELPERS)} (or a *_cap/*_pad "
                        f"derivation) so the launch keeps the reference's "
                        f"bucketed schedule"))
    return out


RULES = {
    "REAP001": rule_purity,
    "REAP002": rule_registry,
    "REAP003": rule_sync,
    "REAP004": rule_shapes,
}
