"""§Roofline table from suite reports.

Counterpart of ``benchmarks/roofline_table.py``, its suite-report mode
(``rows_from_records``, ``rows_from_report``, ``rows_from_latest_report``):
roofline-style rows from engine records, each with its analytic terms
beside the measured time. The measured column prefers
``us_per_call_windowed`` (K calls per event pair) over the sync number
when present, because the bound models the device's throughput, not the
host's launch latency: against sync-mode time a small kernel mostly grades
the launch overhead.

The reference's other mode (``rows``/``load_cells`` over
``artifacts/dryrun/*.json``) renders what ``launch/dryrun.py`` writes; the
port has no dry run yet (ROADMAP queue 1, item 16.5), so that mode is not
here.
"""

from __future__ import annotations

import os

from repro_torch.benchmarks.common import ARTIFACT_DIR, Row, parse_derived


def rows_from_records(records) -> list[Row]:
    """Roofline-style rows from engine records.

    The measured time is the windowed per-call number when the run carried
    one, else the sync number; the derived field keeps both, the record's
    analytic roofline terms and its implementation (``impl=torch|kernel``,
    with the interpret flag on kernel rows run on the CPU).
    """
    out: list[Row] = []
    for r in records:
        if r.status != "ok":
            out.append((f"roofline.{r.name}", 0.0, f"error={r.error}"))
            continue
        terms = parse_derived(r.derived)
        us = (
            r.us_per_call_windowed
            if r.us_per_call_windowed is not None
            else r.us_per_call
        )
        impl = f"impl={r.impl}"
        if r.impl_interpret is not None:
            impl += f";interpret={int(r.impl_interpret)}"
        derived = (
            f"dominant={r.dominant};{impl};sync_us={r.us_per_call:.2f};"
            f"timed={'windowed' if r.us_per_call_windowed is not None else 'sync'};"
            f"flops={terms.get('flops', '0')};bytes={terms.get('bytes', '0')};"
            f"gflops={r.achieved_gflops:.2f};gbps={r.achieved_gbps:.2f}"
        )
        # Kernel rows get a name suffix so a report holding both impls of
        # one workload renders two distinguishable rows.
        suffix = ".kernel" if r.impl == "kernel" else ""
        out.append((f"roofline.{r.name}{suffix}", us, derived))
    return out


def rows_from_report(path: str) -> list[Row]:
    """``rows_from_records`` over a JSON/JSONL suite report on disk."""
    from repro_torch.core.results import load_records

    return rows_from_records(load_records(path))


def rows_from_latest_report() -> list[Row]:
    """Rows from the suite report at ``artifacts/suite_report.json`` (not
    committed: ``--report`` writes it) when one exists, else none."""
    path = os.path.join(ARTIFACT_DIR, "suite_report.json")
    if not os.path.exists(path):
        return []
    try:
        return rows_from_report(path)
    except Exception as e:  # noqa: BLE001 — a stale artifact is not fatal
        return [("roofline.suite_report", 0.0, f"error={e}")]
