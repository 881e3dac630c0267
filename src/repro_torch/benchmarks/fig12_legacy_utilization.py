"""Figs. 1–2: the microbenchmark and basic-algorithm tiers (the SHOC-like
levels 0–1), with the spread of utilization the paper contrasts against
Rodinia's flat profile. Counterpart of
``benchmarks/fig12_legacy_utilization.py``."""

from __future__ import annotations

from repro_torch.benchmarks.common import Row, record_rows
from repro_torch.core.suite import run_suite


def rows(preset: int = 0, *, device: str = "cuda") -> list[Row]:
    records = run_suite(
        levels=(0, 1), preset=preset, iters=3, warmup=1,
        include_backward=False, device=device, verbose=False,
    )
    return record_rows(
        "fig12",
        records,
        lambda r: (
            f"compute10={r.compute_util10};memory10={r.memory_util10};"
            f"dominant={r.dominant};gbps={r.achieved_gbps:.2f}"
        ),
    )
