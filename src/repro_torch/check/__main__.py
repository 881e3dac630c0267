"""CLI for the static contract checker: ``python -m repro_torch.check``.

Runs on a plain Python install — the checker only parses source with the
stdlib ``ast`` module and never imports the code it inspects, so it needs
neither torch nor NumPy.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.check.core import all_checkers, run_checks
from repro_torch.check.schema import update_fingerprint

_EPILOG = """\
rules (see --list-rules for one-line summaries):
  workload-contract   bench registrations vs kernels.ops.KERNEL_OPS
  cache-key           plan/placement axes join both cache keys
  stage-discipline    _timed_stage coverage + zero-overhead hot loops
  schema-drift        BenchmarkRecord shape vs committed fingerprint
  concurrency         lock-owning serve/obs/dist/_build classes mutate under the lock
  dist-proto          every dist/proto.py message registered + round-trips

suppressing a finding:
  put `# repro-check: ignore[<rule>]` on the flagged line or the line
  above it (comma-separate several rules; `*` matches any rule), e.g.

      self._items.append(x)  # repro-check: ignore[concurrency]

after an intentional schema change:
  bump results.SCHEMA_VERSION, then run
  `python -m repro_torch.check --update-schema-fingerprint` and commit the
  regenerated src/repro_torch/check/schema_fingerprint.json.
"""


def _default_root() -> Path:
    # src/repro_torch/check/__main__.py -> repo root is three levels above src/.
    return Path(__file__).resolve().parents[3]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="Static contract checker for the PyTorch port.",
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--root",
        type=Path,
        default=_default_root(),
        help="repo root to check (default: this checkout)",
    )
    parser.add_argument(
        "--rules",
        help="comma-separated subset of rule ids to run (default: all)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit findings as JSON on stdout",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="list registered rules and exit",
    )
    parser.add_argument(
        "--update-schema-fingerprint",
        action="store_true",
        help="rewrite src/repro_torch/check/schema_fingerprint.json from the "
        "live results.py and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for c in all_checkers():
            print(f"{c.rule:20s} {c.description}")
        return 0

    if args.update_schema_fingerprint:
        path = update_fingerprint(args.root)
        print(f"wrote {path}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        findings = run_checks(args.root, rules=rules)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2

    if args.json:
        print(
            json.dumps(
                {
                    "root": str(args.root),
                    "rules": sorted(rules) if rules else [c.rule for c in all_checkers()],
                    "findings": [f.to_dict() for f in findings],
                    "count": len(findings),
                },
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f.format())
        n = len(findings)
        label = "finding" if n == 1 else "findings"
        print(f"repro_torch.check: {n} {label}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
