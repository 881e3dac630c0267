"""§Roofline table: per (arch × shape) roofline terms from the dry run's
records, and rows from suite reports.

Counterpart of ``benchmarks/roofline_table.py``, both modes:

- ``load_cells`` / ``rows`` over ``artifacts/dryrun_torch/*.json``, the
  records ``repro_torch.launch.dryrun`` writes (the reference's read
  ``artifacts/dryrun/``): one row a cell, the compute term's microseconds
  and the record's dominant term, fraction, terms, useful-compute ratio and
  memory, or the cell's skip reason;
- ``rows_from_records``, ``rows_from_report``, ``rows_from_latest_report``:
  roofline-style rows from engine records, each with its analytic terms
  beside the measured time. The measured column prefers
  ``us_per_call_windowed`` (K calls per event pair) over the sync number
  when present, because the bound models the device's throughput, not the
  host's launch latency: against sync-mode time a small kernel mostly
  grades the launch overhead.
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks.common import ARTIFACT_DIR, DRYRUN_DIR, Row, parse_derived


def load_cells(mesh: str = "single", variant: str = "baseline") -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}__{variant}.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def rows(mesh: str = "single", variant: str = "baseline") -> list[Row]:
    out: list[Row] = []
    for c in load_cells(mesh, variant):
        name = f"roofline.{c['arch']}.{c['shape']}.{mesh}"
        if "skip" in c:
            out.append((name, 0.0, f"skip={c['skip']}"))
            continue
        r = c["roofline"]
        mem_gib = sum(c.get("memory", {}).values()) / 2**30
        out.append(
            (
                name,
                r["compute_s"] * 1e6,  # the compute-term microseconds
                f"dominant={r['dominant']};fraction={r['roofline_fraction']:.3f};"
                f"compute_s={r['compute_s']:.4g};memory_s={r['memory_s']:.4g};"
                f"collective_s={r['collective_s']:.4g};"
                f"useful_ratio={c['useful_compute_ratio']:.3f};"
                f"mem_gib={mem_gib:.2f}",
            )
        )
    return out


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
