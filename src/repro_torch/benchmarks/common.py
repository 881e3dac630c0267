"""Shared helpers for the per-figure benchmark drivers.

The port's copy of ``benchmarks/common.py``, unchanged but for
``ARTIFACT_DIR``, which names the repository root's ``artifacts/`` from
here, and ``DRYRUN_DIR``, the port's dry-run records
(``artifacts/dryrun_torch/``, which ``launch/dryrun.py`` writes), never the
reference's ``artifacts/dryrun/``.

Every module exposes ``rows() -> list[(name, us_per_call, derived)]``;
run.py concatenates them into the required ``name,us_per_call,derived`` CSV.
"""

from __future__ import annotations

import os

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")
DRYRUN_DIR = os.path.join(ARTIFACT_DIR, "dryrun_torch")

Row = tuple[str, float, str]

# Derived-field prefix marking a per-benchmark failure row (the engine's
# fault isolation); run.py counts these toward its exit code.
ERROR_PREFIX = "error="


def fmt(rows: list[Row]) -> list[str]:
    return [f"{n},{us:.2f},{d}" for n, us, d in rows]


def parse_derived(derived: str) -> dict[str, str]:
    """Parse a ``k=v;k=v`` derived field back into a dict (the inverse of
    what the figure drivers and serve stats emit); junk fragments without
    '=' are dropped."""
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


def record_rows(tag, records, derive) -> list[Row]:
    """Format suite records as figure rows, surfacing error records.

    ``derive(record) -> str`` builds the derived field for ok records;
    error records become explicit ``error=...`` rows instead of fake zeros.
    """
    out: list[Row] = []
    for r in records:
        if r.status != "ok":
            out.append((f"{tag}.{r.name}", 0.0, f"{ERROR_PREFIX}{r.error};{r.derived}"))
        else:
            out.append((f"{tag}.{r.name}", r.us_per_call, derive(r)))
    return out
