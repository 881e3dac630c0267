"""The suite runner — a thin CLI over the staged execution engine.

Counterpart of ``repro/core/suite.py``, main path only. ``run_suite``
assembles an :class:`~repro_torch.core.plan.ExecutionPlan` (selection by
level / name, preset + overrides, passes, iters / warmup / seed, timing
window, implementation, device) and hands it to an
:class:`~repro_torch.core.engine.Engine`. Output is a CSV table on stdout
plus optional JSON and streaming JSONL reports.

``--device`` defaults to ``cuda``. Without a CUDA device the run stops with
exit 2 and the reason; it never carries on on the CPU unless ``--device
cpu`` asks for it. ``--impl kernel`` times the hand-written kernels for the
workloads that declare one; on the CPU their plain versions run and the
rows say so (``impl_interpret``).

Exit codes: 0 every row ok, 1 error rows present, 2 a configuration error
(unknown name, bad override, no such device).

    PYTHONPATH=src python -m repro_torch.core.suite --names gemm_bf16_nn \\
        softmax --preset 4 --impl kernel --no-backward --jsonl run.jsonl
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Mapping, Sequence

from repro_torch.core.engine import Engine
from repro_torch.core.plan import DEVICES, IMPLS, ExecutionPlan, PlanError
from repro_torch.core.results import BenchmarkRecord, to_csv_lines

__all__ = ["run_suite", "main"]


def run_suite(
    *,
    levels: Sequence[int] = (0, 1, 2),
    names: Sequence[str] | None = None,
    preset: int = 0,
    overrides: Mapping[str, Mapping[str, Any]] | None = None,
    iters: int = 5,
    warmup: int = 2,
    include_backward: bool = True,
    seed: int = 0,
    timing_window: int = 4,
    impl: str = "torch",
    device: str = "cuda",
    report_path: str | None = None,
    jsonl_path: str | None = None,
    verbose: bool = True,
    engine: Engine | None = None,
) -> list[BenchmarkRecord]:
    plan = ExecutionPlan(
        levels=tuple(levels),
        names=tuple(names) if names is not None else None,
        preset=preset,
        overrides=overrides or {},
        include_backward=include_backward,
        iters=iters,
        warmup=warmup,
        seed=seed,
        timing_window=timing_window,
        impl=impl,
        device=device,
    )
    result = (engine or Engine()).run(
        plan, report_path=report_path, jsonl_path=jsonl_path, verbose=verbose
    )
    return result.records


def _parse_overrides(items: Sequence[str]) -> dict[str, dict[str, Any]]:
    """``name.param=value`` CLI overrides -> {name: {param: value}}."""
    out: dict[str, dict[str, Any]] = {}
    for item in items:
        try:
            target, value = item.split("=", 1)
            name, param = target.rsplit(".", 1)
        except ValueError:
            raise PlanError(f"bad --override {item!r}; expected name.param=value") from None
        out.setdefault(name, {})[param] = _parse_value(value)
    return out


def _parse_value(value: str) -> Any:
    """An override's value: an int, a float, a bool (``true``/``false``, any
    case), or else the string itself. The reference has no bool case, so
    there ``srad.fused=False`` arrives as the (true) string ``"False"``."""
    for parse in (int, float):
        try:
            return parse(value)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(value.lower(), value)


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run the Mirovia/Altis suite (PyTorch port)")
    ap.add_argument("--levels", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--names", type=str, nargs="*", default=None)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--override", action="append", default=[],
                    metavar="NAME.PARAM=VALUE",
                    help="Rodinia-style size override, repeatable")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timing-window", type=int, default=4, metavar="K",
                    help="windowed timing: K back-to-back calls per event "
                         "pair alongside the sync-mode number (1 = sync-only)")
    ap.add_argument("--impl", choices=IMPLS, default="torch",
                    help="implementation to time: the plain PyTorch path "
                         "(torch, default) or the hand-written kernels "
                         "(kernel) for workloads that declare one")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where to run (default cuda; a missing CUDA device "
                         "is an error, never a silent CPU run)")
    ap.add_argument("--no-backward", action="store_true")
    ap.add_argument("--report", type=str, default=None, help="JSON report path")
    ap.add_argument("--jsonl", type=str, default=None,
                    help="streaming JSONL report path (with run metadata)")
    args = ap.parse_args(argv)
    try:
        records = run_suite(
            levels=args.levels,
            names=args.names,
            preset=args.preset,
            overrides=_parse_overrides(args.override),
            iters=args.iters,
            warmup=args.warmup,
            seed=args.seed,
            timing_window=args.timing_window,
            impl=args.impl,
            device=args.device,
            include_backward=not args.no_backward,
            report_path=args.report,
            jsonl_path=args.jsonl,
            verbose=False,
        )
    except (PlanError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in to_csv_lines(records):
        print(line)
    errors = [r for r in records if r.status != "ok"]
    for r in errors:
        print(f"# ERROR {r.name}: {r.error}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
