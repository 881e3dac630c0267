"""Observability figure: where each workload's engine time goes.

Counterpart of ``benchmarks/fig_trace.py``. A small selection runs through
its own :class:`~repro_torch.core.engine.Engine` with a live
:class:`~repro_torch.obs.Tracer`, and the figure reports the per-stage wall
breakdown every record carries (``stage_timings_us``): build / place /
tune / compile / measure / characterize, as a share of the pass's staged
wall time. The tracer's span count rides along, so a run whose
instrumentation stopped recording (zero spans) shows in the numbers, not
only in a missing trace file. The times are host clock: the measure
stage's share holds its CUDA-event timing loop, synchronised.

Rows are named ``fig_trace.<benchmark>.<stage>``; ``us_per_call`` is the
stage's wall microseconds and the derived field carries the share of the
pass total plus the run's span count. As a script it prints one breakdown
line a benchmark and can also write the Chrome trace (``--trace-out``):

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_trace --preset 4 \\
        --impl kernel --trace-out run.trace.json
"""

from __future__ import annotations

import sys

from repro_torch.benchmarks.common import ERROR_PREFIX, Row
from repro_torch.core.engine import Engine
from repro_torch.core.suite import run_suite
from repro_torch.obs import Tracer

# A small cross-section: a GEMM, a bandwidth-bound stencil, and a small
# reduction whose fixed stage costs dominate.
DEFAULT_NAMES = ("gemm_f32_nn", "pathfinder", "softmax")

# Stable column order for the figure (the engine's stage order).
STAGES = ("build", "place", "tune", "compile", "measure", "characterize")


class TraceFigureError(ValueError):
    """A sweep that cannot produce the figure (empty selection). main()
    prints the one-line message and exits 2 instead of a traceback."""


def rows(
    preset: int = 0,
    names=DEFAULT_NAMES,
    iters: int = 3,
    trace_out: str | None = None,
    *,
    impl: str = "torch",
    device: str = "cuda",
) -> list[Row]:
    if not names:
        raise TraceFigureError("fig_trace: empty --names selection")
    tracer = Tracer()
    records = run_suite(
        names=list(names),
        preset=preset,
        iters=iters,
        warmup=1,
        include_backward=False,
        verbose=False,
        impl=impl,
        device=device,
        engine=Engine(tracer=tracer),
    )
    spans = len(tracer.events())
    if trace_out:
        tracer.export_chrome(trace_out)
    out: list[Row] = []
    for r in records:
        if r.status != "ok":
            out.append((f"fig_trace.{r.name}", 0.0, f"{ERROR_PREFIX}{r.error};{r.derived}"))
            continue
        timings = r.stage_timings_us or {}
        total = sum(timings.values())
        for stage in STAGES:
            us = timings.get(stage)
            if us is None:
                continue
            share = us / total if total else 0.0
            out.append((
                f"fig_trace.{r.name}.{stage}",
                us,
                f"share={share:.3f};pass_total_us={total:.1f};spans={spans}",
            ))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--names", nargs="*", default=list(DEFAULT_NAMES))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--impl", choices=("torch", "kernel"), default="torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="also write the Chrome trace-event JSON here")
    args = ap.parse_args(argv)

    try:
        out = rows(preset=args.preset, names=tuple(args.names), iters=args.iters,
                   trace_out=args.trace_out, impl=args.impl, device=args.device)
    except TraceFigureError as e:
        print(str(e), file=sys.stderr)
        return 2
    except ValueError as e:  # bad selection, no card: configuration, not a crash
        print(f"fig_trace: {e}", file=sys.stderr)
        return 2
    # Pivot into one breakdown line a benchmark.
    table: dict[str, dict[str, float]] = {}
    errors = 0
    for name, us, derived in out:
        if derived.startswith(ERROR_PREFIX):
            errors += 1
            print(f"# {name}: {derived}", file=sys.stderr)
            continue
        bench, _, stage = name.removeprefix("fig_trace.").rpartition(".")
        table.setdefault(bench, {})[stage] = us
    if not table:
        print(f"fig_trace: zero ok records in the sweep ({errors} error rows, see "
              "above); nothing to tabulate", file=sys.stderr)
        return 1
    print(f"{'benchmark':<28}{'total ms':>10}  stage shares")
    for bench, timings in table.items():
        total = sum(timings.values())
        shares = "  ".join(
            f"{stage}={timings[stage] / total * 100:.1f}%"
            for stage in STAGES
            if stage in timings and total
        )
        print(f"{bench:<28}{total / 1e3:>10.1f}  {shares}")
    if args.trace_out:
        print(f"# trace written to {args.trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
