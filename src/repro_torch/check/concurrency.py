"""concurrency: lock-owning classes mutate their containers under the lock.

Scope: classes under ``serve/``, ``obs/`` and ``dist/``, and in
``kernels/_build.py`` (the launch counters, the loaded library), whose
``__init__`` creates a ``threading.Lock``/``RLock``. For those classes, the containers also
created in ``__init__`` (list/dict/set/deque literals or constructors)
are treated as lock-guarded shared state: any mutation of them from a
method — assignment, augmented assignment, subscript store, or a mutator
call like ``.append``/``.update`` — must be lexically inside a
``with self.<lock>:`` block.

Classes without a lock attribute are skipped on purpose: single-owner
helpers (``_LaneTally``, ``_InflightBatches``) are thread-confined by
design, and flagging them would teach people to sprinkle locks that the
dispatch loop never needed. Reads are also unflagged — the rule exists
to catch torn writes, and read-side tolerance is a per-call-site
judgment the suppression comment can record.
"""

from __future__ import annotations

import ast

from repro_torch.check.core import Context, Finding, checker, dotted_name

RULE = "concurrency"

_SCOPES = (
    "src/repro_torch/serve",
    "src/repro_torch/obs",
    "src/repro_torch/dist",
    "src/repro_torch/kernels/_build.py",
)

_CONTAINER_CTORS = {"list", "dict", "set", "deque", "defaultdict", "OrderedDict"}
_MUTATORS = {
    "append",
    "appendleft",
    "extend",
    "extendleft",
    "insert",
    "remove",
    "pop",
    "popleft",
    "popitem",
    "clear",
    "update",
    "add",
    "discard",
    "setdefault",
}


def _finding(file: str, line: int, message: str) -> Finding:
    return Finding(rule=RULE, severity="error", file=file, line=line, message=message)


def _self_attr(node: ast.AST) -> str | None:
    """``x`` for ``self.x`` (plain attribute on the name ``self``)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_ctor(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    callee = dotted_name(value.func) or ""
    return callee.split(".")[-1] in ("Lock", "RLock")


def _is_container_init(value: ast.expr) -> bool:
    if isinstance(value, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(value, ast.Call):
        callee = dotted_name(value.func) or ""
        return callee.split(".")[-1] in _CONTAINER_CTORS
    return False


def _init_assignments(init: ast.FunctionDef):
    """Yield (attr-name, value-expr) for every self.x = ... in __init__."""
    for node in ast.walk(init):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    yield attr, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            attr = _self_attr(node.target)
            if attr is not None:
                yield attr, node.value


def _is_lock_with(node: ast.With, locks: set[str]) -> bool:
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr in locks:
            return True
    return False


def _mutation(node: ast.AST, guarded_attrs: set[str]) -> tuple[int, str] | None:
    """(line, description) when this node mutates a guarded attribute."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            attr = _self_attr(t)
            if attr in guarded_attrs:
                return node.lineno, f"assignment to self.{attr}"
            if isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr in guarded_attrs:
                    return node.lineno, f"item store into self.{attr}[...]"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr in guarded_attrs:
                return node.lineno, f"self.{attr}.{node.func.attr}()"
    if isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr in guarded_attrs:
                    return node.lineno, f"del self.{attr}[...]"
    return None


def _scan_method(
    rel: str,
    node: ast.AST,
    locked: bool,
    locks: set[str],
    guarded_attrs: set[str],
    findings: list[Finding],
) -> None:
    for child in ast.iter_child_nodes(node):
        child_locked = locked
        if isinstance(child, ast.With) and _is_lock_with(child, locks):
            child_locked = True
        if not locked:
            hit = _mutation(child, guarded_attrs)
            if hit is not None:
                line, what = hit
                lock_name = sorted(locks)[0]
                findings.append(
                    _finding(
                        rel,
                        line,
                        f"{what} outside `with self.{lock_name}:` — this "
                        "attribute is initialised alongside a lock and is "
                        "shared across threads",
                    )
                )
        _scan_method(rel, child, child_locked, locks, guarded_attrs, findings)


def _check_class(rel: str, classdef: ast.ClassDef) -> list[Finding]:
    findings: list[Finding] = []
    init = next(
        (
            n
            for n in classdef.body
            if isinstance(n, ast.FunctionDef) and n.name == "__init__"
        ),
        None,
    )
    if init is None:
        return findings

    locks: set[str] = set()
    guarded_attrs: set[str] = set()
    for attr, value in _init_assignments(init):
        if _is_lock_ctor(value):
            locks.add(attr)
        elif _is_container_init(value):
            guarded_attrs.add(attr)
    if not locks or not guarded_attrs:
        return findings

    for method in classdef.body:
        if not isinstance(method, ast.FunctionDef) or method.name == "__init__":
            continue
        _scan_method(rel, method, False, locks, guarded_attrs, findings)
    return findings


@checker(
    RULE,
    "in serve/, obs/, dist/ and kernels/_build.py, containers owned by a "
    "lock-carrying class are only mutated under that lock",
)
def check_concurrency(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for scope in _SCOPES:
        files = [scope] if scope.endswith(".py") else ctx.iter_py(scope)
        for rel in files:
            tree = ctx.tree(rel)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef):
                    findings.extend(_check_class(rel, node))
    return findings
