"""schema-drift: record shape, csv header, and SCHEMA_VERSION move together.

``BenchmarkRecord`` is the on-disk interchange format — downstream
plotting and the warm-cache comparisons in CI both parse it. This rule
pins the record shape to a committed fingerprint
(``src/repro_torch/check/schema_fingerprint.json``):

* changing the record/metadata fields or the csv header without bumping
  ``SCHEMA_VERSION`` fails (old result files would be misread as new);
* bumping the version (or changing shape with a bump) fails with a
  "regenerate the fingerprint" message — run
  ``python -m repro_torch.check --update-schema-fingerprint`` and commit the
  diff, which makes every schema change reviewable in one file;
* the csv header may only name real record fields.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

from repro_torch.check.core import Context, Finding, checker

RULE = "schema-drift"

_RESULTS_FILE = "src/repro_torch/core/results.py"
FINGERPRINT_FILE = "src/repro_torch/check/schema_fingerprint.json"


def _finding(file: str, line: int, message: str) -> Finding:
    return Finding(rule=RULE, severity="error", file=file, line=line, message=message)


def _class_fields(tree: ast.Module, name: str) -> list[str]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return [
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ]
    return []


def compute_schema(ctx: Context) -> dict | None:
    """The live schema shape as a JSON-ready dict, or None when
    results.py is absent/unparseable."""
    tree = ctx.tree(_RESULTS_FILE)
    if tree is None:
        return None

    version: int | None = None
    csv_header: str | None = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Name)
                    and t.id == "SCHEMA_VERSION"
                    and isinstance(node.value, ast.Constant)
                    and type(node.value.value) is int
                ):
                    version = node.value.value
        if isinstance(node, ast.FunctionDef) and node.name == "csv_header":
            for ret in ast.walk(node):
                if (
                    isinstance(ret, ast.Return)
                    and isinstance(ret.value, ast.Constant)
                    and isinstance(ret.value.value, str)
                ):
                    csv_header = ret.value.value

    return {
        "schema_version": version,
        "record_fields": _class_fields(tree, "BenchmarkRecord"),
        "metadata_fields": _class_fields(tree, "RunMetadata"),
        "csv_header": csv_header,
    }


def update_fingerprint(root: str | Path) -> Path:
    """Write the committed fingerprint from the live results.py."""
    ctx = Context(root)
    schema = compute_schema(ctx)
    if schema is None:
        raise FileNotFoundError(f"{_RESULTS_FILE} not found under {root}")
    path = Path(root) / FINGERPRINT_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(schema, indent=2, sort_keys=True) + "\n")
    return path


@checker(
    RULE,
    "BenchmarkRecord fields, csv_header(), and SCHEMA_VERSION match the "
    "committed fingerprint; shape changes require a version bump",
)
def check_schema_drift(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    schema = compute_schema(ctx)
    if schema is None:
        return findings

    if schema["schema_version"] is None:
        findings.append(
            _finding(
                _RESULTS_FILE,
                1,
                "results.py must define SCHEMA_VERSION as an int literal",
            )
        )
    if not schema["record_fields"]:
        findings.append(
            _finding(_RESULTS_FILE, 1, "BenchmarkRecord defines no fields")
        )
    if schema["csv_header"] is None:
        findings.append(
            _finding(
                _RESULTS_FILE,
                1,
                "csv_header() must return a string literal",
            )
        )
    else:
        bogus = [
            col
            for col in schema["csv_header"].split(",")
            if col not in schema["record_fields"]
        ]
        for col in bogus:
            findings.append(
                _finding(
                    _RESULTS_FILE,
                    1,
                    f"csv_header() names {col!r}, which is not a "
                    "BenchmarkRecord field",
                )
            )

    raw = ctx.source(FINGERPRINT_FILE)
    if raw is None:
        findings.append(
            _finding(
                FINGERPRINT_FILE,
                1,
                "committed schema fingerprint is missing — run "
                "`python -m repro_torch.check --update-schema-fingerprint` "
                "and commit it",
            )
        )
        return findings
    try:
        committed = json.loads(raw)
    except ValueError:
        findings.append(
            _finding(FINGERPRINT_FILE, 1, "schema fingerprint is not valid JSON")
        )
        return findings

    if committed == schema:
        return findings

    if committed.get("schema_version") == schema["schema_version"]:
        findings.append(
            _finding(
                _RESULTS_FILE,
                1,
                "record shape changed without a SCHEMA_VERSION bump — old "
                "result files would be misread as current; bump "
                "SCHEMA_VERSION, then regenerate the fingerprint with "
                "`python -m repro_torch.check --update-schema-fingerprint`",
            )
        )
    else:
        findings.append(
            _finding(
                FINGERPRINT_FILE,
                1,
                f"SCHEMA_VERSION is now {schema['schema_version']} but the "
                f"fingerprint records {committed.get('schema_version')} — "
                "regenerate with "
                "`python -m repro_torch.check --update-schema-fingerprint` and "
                "commit the diff",
            )
        )
    return findings
