"""workload-contract: bench registrations match the kernel registry.

Three sub-checks, all static:

* every ``Workload(...)`` construction under the bench levels passes
  ``batch_dims=`` explicitly — ``batch_dims=None`` is the documented
  opt-out from vmap batching, but *omitting* the kwarg means the author
  never decided, which is exactly the drift this rule exists to catch;
* every string that can flow into a ``kernel=`` kwarg is a key of
  ``kernels.ops.KERNEL_OPS``;
* every module registered in ``KERNEL_OPS`` defines a top-level
  ``tune_space()`` whose returns are literal tuples/lists of dicts with
  string keys and positive-int values (the shape ``_stage_tune`` and the
  autotune cache assume; ``({},)`` is the documented "nothing to tune"
  form).
"""

from __future__ import annotations

import ast

from repro_torch.check.core import Context, Finding, checker

RULE = "workload-contract"

_BENCH_DIRS = (
    "src/repro_torch/bench/level0",
    "src/repro_torch/bench/level1",
    "src/repro_torch/bench/level2",
    "src/repro_torch/bench/dnn",
)
_OPS_FILE = "src/repro_torch/kernels/ops.py"


def _finding(file: str, line: int, message: str) -> Finding:
    return Finding(rule=RULE, severity="error", file=file, line=line, message=message)


def _kernel_ops(ctx: Context) -> tuple[dict[str, str], list[Finding]]:
    """KERNEL_OPS as {op name: kernel module rel path}, plus findings for
    malformed registry entries. Empty dict when ops.py is absent."""
    findings: list[Finding] = []
    tree = ctx.tree(_OPS_FILE)
    if tree is None:
        return {}, findings

    # Map import aliases ("_matmul_mod") back to module files.
    alias_to_rel: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                bound = alias.asname or alias.name
                mod_path = node.module.replace(".", "/")
                alias_to_rel[bound] = f"src/{mod_path}/{alias.name}.py"

    ops: dict[str, str] = {}
    dict_node: ast.Dict | None = None
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "KERNEL_OPS":
                value = node.value
                if isinstance(value, ast.Dict):
                    dict_node = value
                else:
                    findings.append(
                        _finding(
                            _OPS_FILE,
                            node.lineno,
                            "KERNEL_OPS must be a dict literal so the op "
                            "registry stays statically checkable",
                        )
                    )
    if dict_node is None:
        return ops, findings

    for k, v in zip(dict_node.keys, dict_node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            findings.append(
                _finding(
                    _OPS_FILE,
                    (k or v).lineno,
                    "KERNEL_OPS keys must be string literals",
                )
            )
            continue
        rel = alias_to_rel.get(v.id) if isinstance(v, ast.Name) else None
        if rel is None:
            findings.append(
                _finding(
                    _OPS_FILE,
                    v.lineno,
                    f"KERNEL_OPS[{k.value!r}] must be a module imported at "
                    "the top of ops.py so the checker can resolve it",
                )
            )
            continue
        ops[k.value] = rel
    return ops, findings


def _check_tune_space(ctx: Context, op: str, rel: str) -> list[Finding]:
    findings: list[Finding] = []
    tree = ctx.tree(rel)
    if tree is None:
        findings.append(
            _finding(
                _OPS_FILE,
                1,
                f"KERNEL_OPS[{op!r}] points at {rel}, which does not exist",
            )
        )
        return findings

    fn = next(
        (
            n
            for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == "tune_space"
        ),
        None,
    )
    if fn is None:
        findings.append(
            _finding(
                rel,
                1,
                f"kernel module for KERNEL_OPS[{op!r}] must define a "
                "top-level tune_space()",
            )
        )
        return findings

    returns = [n for n in ast.walk(fn) if isinstance(n, ast.Return)]
    if not returns:
        findings.append(
            _finding(rel, fn.lineno, "tune_space() never returns a value")
        )
    for ret in returns:
        findings.extend(_check_space_literal(rel, ret))
    return findings


def _check_space_literal(rel: str, ret: ast.Return) -> list[Finding]:
    value = ret.value
    if not isinstance(value, (ast.Tuple, ast.List)):
        return [
            _finding(
                rel,
                ret.lineno,
                "tune_space() must return a literal tuple/list of dicts "
                "(the autotune cache persists it verbatim)",
            )
        ]
    findings: list[Finding] = []
    if not value.elts:
        findings.append(
            _finding(
                rel,
                ret.lineno,
                "tune_space() must return at least one candidate "
                "(use ({},) when there is nothing to tune)",
            )
        )
    for elt in value.elts:
        if not isinstance(elt, ast.Dict):
            findings.append(
                _finding(
                    rel,
                    elt.lineno,
                    "tune_space() candidates must be dict literals",
                )
            )
            continue
        for k, v in zip(elt.keys, elt.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                findings.append(
                    _finding(
                        rel,
                        elt.lineno,
                        "tune_space() candidate keys must be string literals",
                    )
                )
            ok = (
                isinstance(v, ast.Constant)
                and type(v.value) is int
                and v.value > 0
            )
            if not ok:
                findings.append(
                    _finding(
                        rel,
                        v.lineno,
                        "tune_space() candidate values must be positive "
                        "int literals",
                    )
                )
    return findings


def _kwarg(call: ast.Call, name: str) -> ast.keyword | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def _has_splat(call: ast.Call) -> bool:
    return any(kw.arg is None for kw in call.keywords)


def _kernel_names(node: ast.expr):
    """String constants a kernel= value can evaluate to. Recurses
    into conditional *branches* only — strings in the test (e.g.
    ``"matmul" if impl == "im2col" else None``) are not kernel names.
    Non-literal expressions yield nothing: unanalyzable is not a finding."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            yield node
    elif isinstance(node, ast.IfExp):
        yield from _kernel_names(node.body)
        yield from _kernel_names(node.orelse)


def _check_bench_file(ctx: Context, rel: str, ops: dict[str, str]) -> list[Finding]:
    findings: list[Finding] = []
    tree = ctx.tree(rel)
    if tree is None:
        return findings
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        # batch_dims must be an explicit decision on every direct Workload
        # construction (helpers like dnn_workload() forward it, so the
        # Workload() call inside the helper is the enforcement point).
        if (
            isinstance(node.func, ast.Name)
            and node.func.id == "Workload"
            and _kwarg(node, "batch_dims") is None
            and not _has_splat(node)
        ):
            findings.append(
                _finding(
                    rel,
                    node.lineno,
                    "Workload() must pass batch_dims explicitly "
                    "(batch_dims=None is the opt-out from vmap batching)",
                )
            )
        # kernel= is checked on ANY call — bench modules routinely
        # pass it through construction helpers rather than Workload().
        kw = _kwarg(node, "kernel")
        if kw is not None and ops:
            for const in _kernel_names(kw.value):
                if const.value not in ops:
                    findings.append(
                        _finding(
                            rel,
                            const.lineno,
                            f"kernel={const.value!r} is not a key of "
                            f"kernels.ops.KERNEL_OPS {sorted(ops)}",
                        )
                    )
    return findings


@checker(
    RULE,
    "bench Workload registrations declare batch_dims and name real, "
    "well-formed KERNEL_OPS kernels",
)
def check_workload_contract(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    ops, op_findings = _kernel_ops(ctx)
    findings.extend(op_findings)
    for op, rel in sorted(ops.items()):
        findings.extend(_check_tune_space(ctx, op, rel))
    for bench_dir in _BENCH_DIRS:
        for rel in ctx.iter_py(bench_dir):
            findings.extend(_check_bench_file(ctx, rel, ops))
    return findings
