"""Run the full Mirovia/Altis suite — the paper's headline artifact.

Counterpart of ``examples/run_suite.py``. Level 0 microbenchmarks through
the DNN section (forward + backward), with SHOC-style presets and
Rodinia-style overrides, producing the utilization table + a JSON report.
Runs through the staged engine (build → place → compile → measure →
characterize → report): each workload's callable is built once per pass
(``builds=``, where the reference counts XLA compiles: PyTorch runs
eagerly, and its compile stage is the callable's first call), failures are
isolated per benchmark, and ``--jsonl`` streams records (with run metadata)
as they finish.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.run_suite [--preset 0..4] [--levels 0 1 2]
  PYTHONPATH=src python -m repro_torch.examples.run_suite --names kmeans srad --preset 2
  PYTHONPATH=src python -m repro_torch.examples.run_suite --jsonl artifacts/suite.jsonl
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import Engine, ExecutionPlan, Placement
from repro_torch.core.plan import PLACEMENT_MODES
from repro_torch.core.results import to_csv_lines
from repro_torch.launch.serve import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--levels", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--report", default="artifacts/suite_report.json")
    ap.add_argument("--jsonl", default=None, help="streaming JSONL report path")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--devices", type=int, default=1,
                    help="run on the first N devices")
    ap.add_argument("--placement", choices=PLACEMENT_MODES, default="replicate",
                    help="replicate inputs or shard declared batch dims")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"run_suite: {e}", file=sys.stderr)
        return 2
    plan = ExecutionPlan(
        levels=tuple(args.levels),
        names=tuple(args.names) if args.names else None,
        preset=args.preset,
        iters=args.iters,
        warmup=2,
        placement=Placement(devices=args.devices, mode=args.placement),
        device=args.device,
    )
    engine = Engine()
    result = engine.run(plan, report_path=args.report, jsonl_path=args.jsonl)
    print(f"{'benchmark':<34}{'us/call':>12}  {'compute':<12}{'memory':<12}dominant")
    for r in result.records:
        if r.status != "ok":
            print(f"{r.name:<34}{'ERROR':>12}  {r.error[:60]}")
            continue
        print(
            f"{r.name:<34}{r.us_per_call:>12.1f}  "
            f"|{'#' * r.compute_util10:<10}| |{'#' * r.memory_util10:<10}| {r.dominant}"
        )
    meta = result.metadata
    print(
        f"\n{len(result.records)} rows ({len(result.error_records)} errors); "
        f"backend={meta.backend} devices={meta.devices}/{meta.device_count} "
        f"builds={engine.cache.misses} cache_hits={engine.cache.hits}; "
        f"report: {args.report}" + (f" jsonl: {args.jsonl}" if args.jsonl else "")
    )
    for line in to_csv_lines(result.records)[:5]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
