"""Continuous-batching figure: loop vs lanes vs dynamic batcher goodput at
the *same* offered mixed-shape load.

Counterpart of ``benchmarks/fig_batching.py``. A seeded weighted mix of
shape buckets is sampled once into a request trace, saved, and *replayed*
for every dispatch policy, so ``loop`` (a synchronization a request),
``lanes`` (in-flight windows), fixed ``batched`` and the ``dynamic``
coalescing batcher all face byte-identical arrivals at the same offered
QPS. What differs is how requests map onto device calls, which the goodput,
p99 and occupancy columns compare. A width-w call is ``torch.vmap`` of the
workload's function over w requests (for Pathfinder, the default, the
batched row loop captured as one CUDA graph on the card).

Padding is measured, not hidden: the dynamic batcher pads short batches up
to the next width, and every row carries ``occupancy`` and
``padding_waste``.

As a section (``python -m repro_torch.benchmarks.run --sections
fig_batching``) it emits the standard CSV rows; as a script it renders the
comparison table, and ``--json PATH`` also writes it as JSON:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_batching
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from repro_torch.benchmarks.common import Row, parse_derived, record_rows
from repro_torch.core.engine import Engine
from repro_torch.core.plan import SERVE_DISPATCH, ServeSpec, ShapeBucket
from repro_torch.core.suite import run_suite

DEFAULT_NAME = "pathfinder"
# Two shapes of the same workload, 2:1 — the smallest mix that still
# exercises per-bucket callables, routing and padding.
DEFAULT_MIX = (
    ShapeBucket(preset=0, weight=2.0, overrides=(("cols", 64),)),
    ShapeBucket(preset=0, weight=1.0, overrides=(("cols", 128),)),
)
# loop is the floor, lanes the async middle ground, dynamic the batcher.
DEFAULT_DISPATCHES = ("loop", "lanes", "dynamic")
FAST = dict(iters=1, warmup=0, include_backward=False, verbose=False)


def rows(
    preset: int = 0,
    name: str = DEFAULT_NAME,
    mix=DEFAULT_MIX,
    dispatches=DEFAULT_DISPATCHES,
    qps: float = 45_000.0,
    duration_s: float = 0.7,
    slo_us: float = 20_000.0,
    budget_us: float = 1_000.0,
    max_batch: int = 8,
    concurrency: int = 16,
    lanes: int = 4,
    seed: int = 0,
    trace: str | None = None,
    engine: Engine | None = None,
    *,
    impl: str = "torch",
    device: str = "cuda",
) -> list[Row]:
    """One row per dispatch policy, all replaying the same mixed-shape
    trace at the same offered QPS. The first policy generates (and saves)
    the trace; every later one replays it."""
    engine = engine if engine is not None else Engine()
    out: list[Row] = []
    tmp = None
    if trace is None:
        tmp = tempfile.TemporaryDirectory(prefix="fig_batching_")
        trace = os.path.join(tmp.name, "mix_trace.jsonl")
    try:
        for dispatch in dispatches:
            serve = ServeSpec(
                mode="open", qps=qps, duration_s=duration_s,
                concurrency=concurrency, lanes=lanes, slo_us=slo_us,
                dispatch=dispatch, mix=tuple(mix), trace=trace,
                batch_budget_us=budget_us, max_batch=max_batch,
            )
            records = run_suite(
                names=[name], preset=preset, serve=serve, seed=seed, engine=engine,
                impl=impl, device=device, **FAST,
            )

            def extra(r, dispatch=dispatch):
                buckets = "/".join(
                    f"{label}:p99={b['p99_us']:.0f}"
                    for label, b in sorted((r.bucket_latency_us or {}).items())
                )
                return (
                    f"dispatch={dispatch};qps={r.achieved_qps:.1f};"
                    f"goodput_qps={r.goodput_qps:.1f};"
                    f"p50_us={r.latency_p50_us:.1f};"
                    f"p99_us={r.latency_p99_us:.1f};"
                    f"occupancy={r.batch_occupancy:.3f};"
                    f"padding_waste={r.padding_waste:.3f};"
                    f"batches={r.serve_batches};buckets={buckets};"
                )

            out.extend(
                (f"{n}.{dispatch}", us, derived)
                for n, us, derived in record_rows("fig_batching", records, extra)
            )
    finally:
        if tmp is not None:
            tmp.cleanup()
    return out


def main(argv=None) -> int:
    import argparse

    from repro_torch.core.suite import _parse_mix

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--name", default=DEFAULT_NAME)
    ap.add_argument("--mix", default=None, metavar="P[/K=V...][@W],...",
                    help="weighted shape buckets (suite --serve-mix grammar); "
                         "default: cols=64 twice-weighted against cols=128")
    ap.add_argument("--dispatches", nargs="*", default=list(DEFAULT_DISPATCHES),
                    choices=list(SERVE_DISPATCH))
    ap.add_argument("--qps", type=float, default=45_000.0,
                    help="offered load, identical for every dispatch policy")
    ap.add_argument("--duration", type=float, default=0.7)
    ap.add_argument("--slo-us", type=float, default=20_000.0)
    ap.add_argument("--budget-us", type=float, default=1_000.0,
                    help="dynamic batcher coalescing latency budget")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="trace path: generated and saved on first use, replayed "
                         "after (default: a throwaway temporary file)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the comparison as JSON")
    ap.add_argument("--impl", choices=("torch", "kernel"), default="torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    mix = _parse_mix(args.mix) if args.mix else DEFAULT_MIX
    try:
        table = rows(
            preset=args.preset, name=args.name, mix=mix,
            dispatches=tuple(args.dispatches), qps=args.qps,
            duration_s=args.duration, slo_us=args.slo_us,
            budget_us=args.budget_us, max_batch=args.max_batch,
            seed=args.seed, trace=args.trace, impl=args.impl, device=args.device,
        )
    except ValueError as e:  # bad selection, no card: configuration, not a crash
        print(f"fig_batching: {e}", file=sys.stderr)
        return 2
    ok = [row for row in table if "goodput_qps=" in row[2]]
    if not ok:
        print(f"fig_batching: no ok serve records out of {len(table)} rows; "
              "see stderr for per-benchmark errors", file=sys.stderr)
        return 1
    print(
        f"# offered load: {args.qps:.0f} qps, mix "
        + ",".join(f"{b.label}@{b.weight:g}" for b in mix)
        + f", slo {args.slo_us:.0f}us, budget {args.budget_us:.0f}us",
        file=sys.stderr,
    )
    print(
        f"{'dispatch':<10}{'qps':>10}{'goodput':>10}{'p50_us':>10}"
        f"{'p99_us':>10}{'occupancy':>11}{'padding':>9}{'batches':>9}"
    )
    modes: dict[str, dict] = {}
    for _name, _us, derived in ok:
        f = parse_derived(derived)
        m = modes[f["dispatch"]] = {
            "achieved_qps": float(f["qps"]),
            "goodput_qps": float(f["goodput_qps"]),
            "p50_us": float(f["p50_us"]),
            "p99_us": float(f["p99_us"]),
            "occupancy": float(f["occupancy"]),
            "padding_waste": float(f["padding_waste"]),
            "batches": int(f["batches"]),
        }
        print(
            f"{f['dispatch']:<10}{m['achieved_qps']:>10.1f}{m['goodput_qps']:>10.1f}"
            f"{m['p50_us']:>10.1f}{m['p99_us']:>10.1f}"
            f"{m['occupancy']:>11.3f}{m['padding_waste']:>9.3f}{m['batches']:>9d}"
        )
    ratio = None
    if "loop" in modes and "dynamic" in modes and modes["loop"]["goodput_qps"]:
        ratio = modes["dynamic"]["goodput_qps"] / modes["loop"]["goodput_qps"]
        print(f"# dynamic/loop goodput: {ratio:.2f}x", file=sys.stderr)
    if args.json:
        import torch

        payload = {
            "kind": "fig_batching",
            "device": args.device,
            "device_name": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
            "torch_version": torch.__version__,
            "name": args.name,
            "mix": ",".join(f"{b.label}@{b.weight:g}" for b in mix),
            "offered_qps": args.qps,
            "duration_s": args.duration,
            "slo_us": args.slo_us,
            "budget_us": args.budget_us,
            "max_batch": args.max_batch,
            "seed": args.seed,
            "modes": modes,
        }
        if ratio is not None:
            payload["dynamic_over_loop_goodput"] = round(ratio, 3)
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
