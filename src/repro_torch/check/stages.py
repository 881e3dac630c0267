"""stage-discipline: stage timing and the zero-overhead hot-path contract.

Two sub-checks:

* every ``self._stage_*`` call in ``engine.py`` happens under a
  ``with self._timed_stage(...)`` block — or inside another ``_stage_*``
  method, whose own caller already opened the span. A bare stage call
  produces a benchmark record whose ``stage_timings_us`` silently omits
  real work, which skews the overhead accounting the tracing layer
  reports;
* the designated hot loops (windowed timer, lane drain, batcher flush)
  contain no tracer/log/print calls except under an ``if ...enabled:``
  guard — the zero-overhead contract, made static. The guarded
  pattern in ``DispatchLane.submit`` is the canonical form.
"""

from __future__ import annotations

import ast

from repro_torch.check.core import Context, Finding, checker, dotted_name

RULE = "stage-discipline"

_ENGINE_FILE = "src/repro_torch/core/engine.py"

# (file, class-or-None, function) triples naming the hot loops whose inner
# bodies must stay instrumentation-free. These are the code paths that run
# once per timed sample / request / batch — any unguarded tracer or log
# call there is measured as benchmark time.
_HOT_LOOPS: tuple[tuple[str, str | None, str], ...] = (
    ("src/repro_torch/core/harness.py", None, "time_fn"),
    ("src/repro_torch/serve/lanes.py", "DispatchLane", "submit"),
    ("src/repro_torch/serve/lanes.py", "DispatchLane", "poll"),
    ("src/repro_torch/serve/lanes.py", "DispatchLane", "drain"),
    ("src/repro_torch/serve/lanes.py", "DispatchLane", "_finish"),
    ("src/repro_torch/serve/lanes.py", None, "serve_loop"),
    ("src/repro_torch/serve/batcher.py", None, "_coalescing_serve"),
    ("src/repro_torch/serve/batcher.py", None, "serve_mixed_loop"),
    ("src/repro_torch/serve/batcher.py", None, "serve_mixed_lanes"),
    ("src/repro_torch/serve/batcher.py", "_InflightBatches", "poll"),
    ("src/repro_torch/serve/batcher.py", "_InflightBatches", "_finish"),
)


def _finding(file: str, line: int, message: str) -> Finding:
    return Finding(rule=RULE, severity="error", file=file, line=line, message=message)


# --- stage calls must be timed -------------------------------------------


def _is_timed_stage_with(node: ast.With) -> bool:
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            callee = dotted_name(expr.func) or ""
            if callee.split(".")[-1] == "_timed_stage":
                return True
    return False


def _scan_for_stage_calls(
    node: ast.AST, timed: bool, findings: list[Finding]
) -> None:
    """Walk statements carrying a "we are under _timed_stage" flag."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.FunctionDef):
            # Nested defs get their own scan; being lexically inside a
            # with-block does not mean the *call* happens there.
            _scan_for_stage_calls(child, False, findings)
            continue
        child_timed = timed
        if isinstance(child, ast.With) and _is_timed_stage_with(child):
            child_timed = True
        if isinstance(child, ast.Call):
            callee = dotted_name(child.func) or ""
            last = callee.split(".")[-1]
            if last.startswith("_stage_") and not timed:
                findings.append(
                    _finding(
                        _ENGINE_FILE,
                        child.lineno,
                        f"{last}() called outside a _timed_stage span — the "
                        "record's stage_timings_us will omit this work",
                    )
                )
        _scan_for_stage_calls(child, child_timed, findings)


def _check_engine_stages(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    tree = ctx.tree(_ENGINE_FILE)
    if tree is None:
        return findings
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        # A _stage_* method runs entirely inside its caller's span, so its
        # own nested stage calls (e.g. _stage_tune -> _stage_compile) are
        # already timed.
        inside_stage = node.name.startswith("_stage_")
        _scan_for_stage_calls(node, inside_stage, findings)
    return findings


# --- hot loops must stay instrumentation-free ----------------------------


def _is_enabled_guard(test: ast.expr) -> bool:
    """True for any test that consults a tracer `.enabled` flag
    (`if tracer.enabled:`, `if t.enabled and ...:`, `if not t.enabled:`)."""
    return any(
        isinstance(n, ast.Attribute) and n.attr == "enabled"
        for n in ast.walk(test)
    )


def _instrumentation_call(call: ast.Call) -> str | None:
    callee = dotted_name(call.func)
    if callee is None:
        return None
    if callee == "print":
        return "print()"
    parts = callee.split(".")
    if parts[0] in ("logging", "logger", "log"):
        return f"{callee}()"
    if "counters" in parts[:-1]:
        return f"{callee}()"
    if parts[-1] in ("span", "event"):
        return f"{callee}()"
    return None


def _scan_hot_body(
    rel: str, node: ast.AST, guarded: bool, findings: list[Finding]
) -> None:
    for child in ast.iter_child_nodes(node):
        child_guarded = guarded
        if isinstance(child, ast.If) and _is_enabled_guard(child.test):
            # Body runs only when tracing is on; orelse stays hot.
            _scan_hot_body(rel, child.test, guarded, findings)
            for stmt in child.body:
                _scan_hot_body(rel, stmt, True, findings)
            for stmt in child.orelse:
                _scan_hot_body(rel, stmt, guarded, findings)
            continue
        if isinstance(child, ast.Call) and not guarded:
            label = _instrumentation_call(child)
            if label is not None:
                findings.append(
                    _finding(
                        rel,
                        child.lineno,
                        f"hot loop calls {label} without an "
                        "`if tracer.enabled:` guard — this cost lands "
                        "inside the timed region (the zero-overhead contract)",
                    )
                )
        _scan_hot_body(rel, child, child_guarded, findings)


def _find_hot_fn(
    tree: ast.Module, cls: str | None, name: str
) -> ast.FunctionDef | None:
    if cls is None:
        scope: list[ast.stmt] = tree.body
    else:
        classdef = next(
            (
                n
                for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == cls
            ),
            None,
        )
        if classdef is None:
            return None
        scope = classdef.body
    return next(
        (
            n
            for n in scope
            if isinstance(n, ast.FunctionDef) and n.name == name
        ),
        None,
    )


@checker(
    RULE,
    "engine stage calls go through _timed_stage; designated hot loops have "
    "no unguarded tracer/log/print calls",
)
def check_stage_discipline(ctx: Context) -> list[Finding]:
    findings = _check_engine_stages(ctx)
    for rel, cls, name in _HOT_LOOPS:
        tree = ctx.tree(rel)
        if tree is None:
            continue
        fn = _find_hot_fn(tree, cls, name)
        if fn is None:
            continue
        _scan_hot_body(rel, fn, False, findings)
    return findings
