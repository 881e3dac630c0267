"""cache-key: every axis that reaches binding joins both cache keys.

A plan/placement axis that changes what gets compiled but is missing
from the cache key makes the warm path serve a stale executable as fresh
data — the worst failure mode a benchmarking suite has, because the
numbers still look plausible. This rule makes "added an axis, forgot the
key" a CI failure:

* every non-``self`` parameter of ``Engine._cache_key`` and
  ``Engine._bucket_key`` must be referenced inside the function (a
  parameter that does not reach the key is an axis that was plumbed in
  and then dropped);
* every field of the ``Placement`` dataclass (parsed from ``plan.py``)
  must appear as ``placement.<field>`` in *both* key functions;
* the two key functions' tuples must have the same arity — they describe
  the same executable identity, so one growing without the other means a
  new axis joined only one of them;
* every ``*.disk_cache.<load/store/...>`` call site must pass a key that
  was produced by ``_cache_key``/``_bucket_key`` (or arrived as a
  parameter named ``key``), never an ad-hoc tuple;
* ``HloDiskCache._tune_path`` (the tune sidecar's file name) must hash
  ``repr(key)`` of the whole key — subscripting the key there would
  silently drop axes from the digest, and a winner timed for one row would
  be restored for another.
"""

from __future__ import annotations

import ast

from repro_torch.check.core import Context, Finding, checker, dotted_name

RULE = "cache-key"

_ENGINE_FILE = "src/repro_torch/core/engine.py"
_PLAN_FILE = "src/repro_torch/core/plan.py"
_HLOCACHE_FILE = "src/repro_torch/core/hlocache.py"

_KEY_FUNCTIONS = ("_cache_key", "_bucket_key")
_DISK_CACHE_METHODS = {"load", "store", "note_skip", "load_tuned", "store_tuned"}


def _finding(file: str, line: int, message: str) -> Finding:
    return Finding(rule=RULE, severity="error", file=file, line=line, message=message)


def _placement_fields(ctx: Context) -> set[str]:
    tree = ctx.tree(_PLAN_FILE)
    if tree is None:
        return set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Placement":
            return {
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            }
    return set()


def _find_methods(tree: ast.Module, names: tuple[str, ...]) -> dict[str, ast.FunctionDef]:
    out: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            out[node.name] = node
    return out


def _check_key_function(
    fn: ast.FunctionDef, placement_fields: set[str]
) -> tuple[list[Finding], int]:
    """Findings for one key function, plus the arity of its key tuple."""
    findings: list[Finding] = []

    params = [
        a.arg
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        if a.arg != "self"
    ]
    used_names = {
        n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
    }
    for p in params:
        if p not in used_names:
            findings.append(
                _finding(
                    _ENGINE_FILE,
                    fn.lineno,
                    f"{fn.name}() parameter {p!r} never reaches the key — "
                    "an axis was plumbed in and then dropped",
                )
            )

    attrs = {
        d
        for n in ast.walk(fn)
        if isinstance(n, ast.Attribute) and (d := dotted_name(n)) is not None
    }
    for field in sorted(placement_fields):
        if f"placement.{field}" not in attrs:
            findings.append(
                _finding(
                    _ENGINE_FILE,
                    fn.lineno,
                    f"{fn.name}() omits Placement.{field} — every Placement "
                    "axis must join the cache key",
                )
            )

    arity = max(
        (len(n.elts) for n in ast.walk(fn) if isinstance(n, ast.Tuple)),
        default=0,
    )
    return findings, arity


def _own_nodes(fn: ast.FunctionDef):
    """Nodes of a function body excluding nested function subtrees
    (nested defs are scanned separately, inheriting captured names)."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _check_disk_cache_sites(tree: ast.Module) -> list[Finding]:
    """Every disk_cache call's key argument must come from a key function
    or a parameter literally named ``key``/``base_key``. Closures see the
    enclosing function's key bindings (captured names)."""
    findings: list[Finding] = []

    def scan_fn(fn: ast.FunctionDef, inherited: frozenset[str]) -> None:
        key_vars = set(inherited)
        key_vars.update(
            a.arg
            for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
            if a.arg in ("key", "base_key")
        )
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                callee = dotted_name(node.value.func) or ""
                if callee.split(".")[-1] in _KEY_FUNCTIONS:
                    key_vars.update(
                        t.id for t in node.targets if isinstance(t, ast.Name)
                    )
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None:
                continue
            parts = callee.split(".")
            if len(parts) < 3 or parts[-2] != "disk_cache":
                continue
            if parts[-1] not in _DISK_CACHE_METHODS:
                continue
            if not node.args:
                continue
            first = node.args[0]
            ok = isinstance(first, ast.Name) and first.id in key_vars
            if not ok:
                findings.append(
                    _finding(
                        _ENGINE_FILE,
                        node.lineno,
                        f"disk_cache.{parts[-1]}() key must be bound from "
                        "_cache_key()/_bucket_key(), not built ad hoc — "
                        "ad-hoc keys drift from the compile-cache key",
                    )
                )
        for node in _own_nodes(fn):
            if isinstance(node, ast.FunctionDef):
                scan_fn(node, frozenset(key_vars))

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            scan_fn(node, frozenset())
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    scan_fn(item, frozenset())
    return findings


def _check_hlocache_path(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    tree = ctx.tree(_HLOCACHE_FILE)
    if tree is None:
        return findings
    fn = _find_methods(tree, ("_tune_path",)).get("_tune_path")
    if fn is None:
        return findings
    key_params = {
        a.arg
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        if a.arg != "self"
    }
    has_repr_of_key = any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Name)
        and n.func.id == "repr"
        and n.args
        and isinstance(n.args[0], ast.Name)
        and n.args[0].id in key_params
        for n in ast.walk(fn)
    )
    if not has_repr_of_key:
        findings.append(
            _finding(
                _HLOCACHE_FILE,
                fn.lineno,
                "HloDiskCache._tune_path must digest repr(key) of the whole "
                "key tuple so every axis reaches the on-disk path",
            )
        )
    for n in ast.walk(fn):
        if (
            isinstance(n, ast.Subscript)
            and isinstance(n.value, ast.Name)
            and n.value.id in key_params
        ):
            findings.append(
                _finding(
                    _HLOCACHE_FILE,
                    n.lineno,
                    "HloDiskCache._tune_path must not subscript the key — "
                    "selecting elements drops axes from the digest",
                )
            )
    return findings


@checker(
    RULE,
    "every ExecutionPlan/Placement axis joins both the callable-cache and "
    "tune-sidecar keys; disk-cache call sites use keys the key functions made",
)
def check_cache_key(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    tree = ctx.tree(_ENGINE_FILE)
    if tree is not None:
        placement_fields = _placement_fields(ctx)
        functions = _find_methods(tree, _KEY_FUNCTIONS)
        arities: dict[str, int] = {}
        for name in _KEY_FUNCTIONS:
            fn = functions.get(name)
            if fn is None:
                findings.append(
                    _finding(
                        _ENGINE_FILE,
                        1,
                        f"engine.py must define {name}() — it is the single "
                        "source of executable identity",
                    )
                )
                continue
            fn_findings, arity = _check_key_function(fn, placement_fields)
            findings.extend(fn_findings)
            arities[name] = arity
        if len(arities) == len(_KEY_FUNCTIONS):
            a, b = (arities[n] for n in _KEY_FUNCTIONS)
            if a != b:
                findings.append(
                    _finding(
                        _ENGINE_FILE,
                        functions[_KEY_FUNCTIONS[1]].lineno,
                        f"_cache_key builds a {a}-axis key but _bucket_key "
                        f"builds {b} — a new axis joined only one of them",
                    )
                )
        findings.extend(_check_disk_cache_sites(tree))
    findings.extend(_check_hlocache_path(ctx))
    return findings
