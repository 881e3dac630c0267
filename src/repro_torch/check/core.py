"""Checker infrastructure: findings, the rule registry, suppressions.

A *checker* is a function ``(Context) -> list[Finding]`` registered under
a rule id with :func:`checker`. The :class:`Context` gives checkers
cached source text and parsed ASTs for files under one repo root, so the
whole run parses each file at most once and never imports the code it
inspects (a checker must work in an environment without torch).

Suppression
-----------

A finding is suppressed by a comment on the flagged line or the line
directly above it::

    self._items.append(x)  # repro-check: ignore[concurrency]
    # repro-check: ignore[stage-discipline] -- covered by the outer span
    entry = self._stage_compile(...)

The bracket takes a comma-separated list of rule ids, or ``*`` for any
rule. Suppressions are per-line and per-rule by design: a blanket file
opt-out would defeat the point of the checker.

Checkers *skip* (emit nothing) when the file a rule targets does not
exist under the root — that is what lets the seeded-violation fixtures in
``tests/test_torch_check.py`` stay minimal. The live repo always has every
target, and ``tests/test_torch_check.py`` asserts it is check-clean.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Iterable

__all__ = [
    "Finding",
    "Context",
    "Checker",
    "checker",
    "all_checkers",
    "run_checks",
    "dotted_name",
]

_SUPPRESS_RE = re.compile(r"#\s*repro-check:\s*ignore\[([^\]]*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: where it is and what the contract says."""

    rule: str
    severity: str  # "error" (gates CI) — the field exists for future tiers
    file: str  # repo-root-relative posix path
    line: int
    message: str

    def format(self) -> str:
        return f"{self.file}:{self.line}: {self.severity}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Context:
    """Parsed-source access for checkers, rooted at one repo checkout."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self._sources: dict[str, str | None] = {}
        self._trees: dict[str, ast.Module | None] = {}
        self._suppressions: dict[str, dict[int, set[str]]] = {}

    def source(self, rel: str) -> str | None:
        """File text for a root-relative path, or None when absent."""
        if rel not in self._sources:
            path = self.root / rel
            try:
                self._sources[rel] = path.read_text()
            except OSError:
                self._sources[rel] = None
        return self._sources[rel]

    def tree(self, rel: str) -> ast.Module | None:
        """Parsed AST, or None when the file is absent or unparseable
        (a syntax error is a louder failure than any contract finding —
        the tier-1 suite and CI both catch it on import)."""
        if rel not in self._trees:
            text = self.source(rel)
            if text is None:
                self._trees[rel] = None
            else:
                try:
                    self._trees[rel] = ast.parse(text, filename=rel)
                except SyntaxError:
                    self._trees[rel] = None
        return self._trees[rel]

    def iter_py(self, rel_dir: str) -> list[str]:
        """Sorted root-relative paths of every .py file under a directory
        (empty when the directory does not exist)."""
        base = self.root / rel_dir
        if not base.is_dir():
            return []
        return sorted(
            p.relative_to(self.root).as_posix() for p in base.rglob("*.py")
        )

    def suppressions(self, rel: str) -> dict[int, set[str]]:
        """line number -> rule ids suppressed on that line."""
        if rel not in self._suppressions:
            out: dict[int, set[str]] = {}
            text = self.source(rel)
            if text is not None:
                for i, line in enumerate(text.splitlines(), start=1):
                    m = _SUPPRESS_RE.search(line)
                    if m:
                        out[i] = {
                            r.strip() for r in m.group(1).split(",") if r.strip()
                        }
            self._suppressions[rel] = out
        return self._suppressions[rel]

    def suppressed(self, finding: Finding) -> bool:
        sup = self.suppressions(finding.file)
        for line in (finding.line, finding.line - 1):
            rules = sup.get(line)
            if rules and (finding.rule in rules or "*" in rules):
                return True
        return False


@dataclasses.dataclass(frozen=True)
class Checker:
    rule: str
    description: str
    fn: Callable[[Context], list[Finding]]


_CHECKERS: dict[str, Checker] = {}


def checker(rule: str, description: str):
    """Register a checker function under a rule id."""

    def register(fn: Callable[[Context], list[Finding]]):
        if rule in _CHECKERS:
            raise ValueError(f"duplicate checker rule id: {rule!r}")
        _CHECKERS[rule] = Checker(rule=rule, description=description, fn=fn)
        return fn

    return register


def all_checkers() -> list[Checker]:
    _load_rules()
    return [_CHECKERS[r] for r in sorted(_CHECKERS)]


def _load_rules() -> None:
    # Rule modules self-register on import, like the bench registry.
    from repro_torch.check import (  # noqa: F401
        cachekey,
        concurrency,
        contracts,
        distproto,
        schema,
        stages,
    )


def run_checks(
    root: str | Path, rules: Iterable[str] | None = None
) -> list[Finding]:
    """Run (a subset of) the registered checkers against one repo root;
    returns unsuppressed findings sorted by (file, line, rule)."""
    _load_rules()
    wanted = set(rules) if rules is not None else None
    if wanted is not None:
        unknown = wanted - set(_CHECKERS)
        if unknown:
            raise KeyError(
                f"unknown rule(s) {sorted(unknown)}; "
                f"known: {sorted(_CHECKERS)}"
            )
    ctx = Context(root)
    findings: list[Finding] = []
    for rule in sorted(_CHECKERS):
        if wanted is not None and rule not in wanted:
            continue
        findings.extend(_CHECKERS[rule].fn(ctx))
    findings = [f for f in findings if not ctx.suppressed(f)]
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return findings


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain (None for anything else —
    calls, subscripts, literals inside the chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
