"""Concurrency figure: dispatch-lane speedup, client architectures, and
co-location interference.

Counterpart of ``benchmarks/fig_concurrency.py``: the §V-B HyperQ study,
generalized suite-wide through the serving subsystem
(``repro_torch.serve``). Each workload is served closed-loop at each lane
count in the sweep under *both* host issue architectures, side by side, and
the dispatch speedup is its achieved QPS over the same client's narrowest
lane count (lanes=1, concurrency=1: one request in flight, the serial
floor). The ``single`` client issues every lane from one thread, the
``threaded`` client one thread a lane, all enqueueing on the card's current
stream; threaded rows carry the measured per-request dispatch overhead.

Both clients serve the engine's *one* bound callable a workload (the cache
is keyed on the workload, not the client), and the script prints the cache
traffic so "no rebuild" is visible. The co-location half serves a workload
pair through split lanes (``ServeSpec.colocate``) and reports both tenants'
p50 slowdown against isolation.

As a section (``python -m repro_torch.benchmarks.run --sections
fig_concurrency``) it emits the standard CSV rows; as a script it renders
the tables:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_concurrency --preset 4 \\
        --impl kernel
"""

from __future__ import annotations

import sys

from repro_torch.benchmarks.common import Row, parse_derived, record_rows
from repro_torch.core.engine import Engine
from repro_torch.core.plan import SERVE_CLIENTS, ServeSpec
from repro_torch.core.suite import run_suite

DEFAULT_LANES = (1, 2, 4, 8, 16, 32)
DEFAULT_CLIENTS = SERVE_CLIENTS  # ("single", "threaded")
# One wavefront DP workload (the paper's HyperQ subject) and one GEMM, so
# the dispatch curve and the interference pair cover both regimes.
DEFAULT_NAMES = ("pathfinder", "gemm_f32_nn")
FAST = dict(iters=1, warmup=0, include_backward=False, verbose=False)


def _serve_rows(tag: str, records, extra) -> list[Row]:
    return record_rows(
        tag,
        records,
        lambda r: (
            f"{extra(r)}p50_us={r.latency_p50_us:.1f};"
            f"p99_us={r.latency_p99_us:.1f};qps={r.achieved_qps:.1f}"
        ),
    )


def lane_sweep_rows(
    preset: int = 0,
    names=DEFAULT_NAMES,
    lanes_sweep=DEFAULT_LANES,
    duration_s: float = 0.3,
    clients=DEFAULT_CLIENTS,
    engine: Engine | None = None,
    *,
    impl: str = "torch",
    device: str = "cuda",
) -> list[Row]:
    """One row per (workload, client, lane count): achieved QPS plus the
    dispatch speedup over the same (workload, client)'s narrowest lane
    count. Threaded rows add ``dispatch_overhead_us``."""
    engine = engine if engine is not None else Engine()
    out: list[Row] = []
    base_qps: dict[tuple[str, str], float] = {}
    # Ascending order puts the baseline first, so every later row can carry
    # a speedup whatever subset the caller swept.
    for n in sorted(set(lanes_sweep)):
        # lanes=1 runs one request at a time (the serial-dispatch floor);
        # wider sweeps keep 2 in-flight requests a lane.
        concurrency = 1 if n == 1 else 2 * n
        for client in clients:
            serve = ServeSpec(
                mode="closed", concurrency=concurrency, lanes=n,
                duration_s=duration_s, client=client,
            )
            records = run_suite(
                names=list(names), preset=preset, serve=serve, engine=engine,
                impl=impl, device=device, **FAST,
            )
            for r in records:
                if r.status == "ok" and r.achieved_qps:
                    base_qps.setdefault((r.name, client), r.achieved_qps)

            def extra(r, n=n, concurrency=concurrency, client=client):
                base = base_qps.get((r.name, client))
                speedup = f"{r.achieved_qps / base:.2f}" if base and r.achieved_qps else "-"
                overhead = (
                    f"{r.dispatch_overhead_us:.1f}" if r.dispatch_overhead_us is not None else "-"
                )
                return (
                    f"client={client};lanes={n};concurrency={concurrency};"
                    f"dispatch_speedup={speedup};dispatch_overhead_us={overhead};"
                )

            out.extend(
                (f"{name}.{client}.l{n}", us, derived)
                for name, us, derived in _serve_rows("fig_concurrency", records, extra)
            )
    return out


def colocation_rows(
    preset: int = 0,
    names=DEFAULT_NAMES,
    duration_s: float = 0.3,
    lanes: int = 2,
    concurrency: int = 4,
    engine: Engine | None = None,
    *,
    impl: str = "torch",
    device: str = "cuda",
) -> list[Row]:
    """Both tenants' slowdown against isolation for each adjacent pair in
    ``names`` (the interference matrix's off-diagonal samples)."""
    engine = engine if engine is not None else Engine()
    out: list[Row] = []
    for a, b in zip(names, names[1:]):
        serve = ServeSpec(
            mode="closed", concurrency=concurrency, lanes=lanes,
            duration_s=duration_s, colocate=b,
        )
        records = run_suite(
            names=[a], preset=preset, serve=serve, engine=engine, impl=impl,
            device=device, **FAST,
        )
        out.extend(
            _serve_rows(
                "fig_concurrency.colocate",
                records,
                lambda r, a=a, b=b: (
                    f"pair={a}+{b};slowdown="
                    + (
                        f"{r.slowdown_vs_isolated:.2f};"
                        if r.slowdown_vs_isolated is not None
                        else "-;"
                    )
                ),
            )
        )
    return out


def rows(preset: int = 0, *, impl: str = "torch", device: str = "cuda") -> list[Row]:
    engine = Engine()
    return lane_sweep_rows(preset=preset, engine=engine, impl=impl, device=device) + (
        colocation_rows(preset=preset, engine=engine, impl=impl, device=device)
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--names", nargs="*", default=list(DEFAULT_NAMES))
    ap.add_argument("--lanes", type=int, nargs="*", default=list(DEFAULT_LANES))
    ap.add_argument("--clients", nargs="*", choices=list(SERVE_CLIENTS),
                    default=list(DEFAULT_CLIENTS),
                    help="host issue architectures to sweep side by side")
    ap.add_argument("--duration", type=float, default=0.3)
    ap.add_argument("--impl", choices=("torch", "kernel"), default="torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    engine = Engine()
    misses0 = engine.cache.misses
    try:
        sweep = lane_sweep_rows(
            preset=args.preset, names=tuple(args.names), lanes_sweep=tuple(args.lanes),
            duration_s=args.duration, clients=tuple(args.clients), engine=engine,
            impl=args.impl, device=args.device,
        )
    except ValueError as e:  # bad selection, no card: configuration, not a crash
        print(f"fig_concurrency: {e}", file=sys.stderr)
        return 2
    ok = [row for row in sweep if "qps=" in row[2]]
    if not ok:
        print(f"fig_concurrency: no ok serve records out of {len(sweep)} rows; "
              "see stderr for per-benchmark errors", file=sys.stderr)
        return 1

    # Pivot: (benchmark, client) x lane count -> (qps, speedup).
    table: dict[tuple[str, str], dict[int, tuple[float, str]]] = {}
    counts: list[int] = []
    for name, _us, derived in ok:
        fields = parse_derived(derived)
        n = int(fields["lanes"])
        if n not in counts:
            counts.append(n)
        client = fields.get("client", "single")
        bench = (
            name.removeprefix("fig_concurrency.").rsplit(".l", 1)[0].removesuffix(f".{client}")
        )
        table.setdefault((bench, client), {})[n] = (float(fields["qps"]),
                                                    fields["dispatch_speedup"])
    label_w = 34
    print(f"{'benchmark [client]':<{label_w}}" + "".join(
        f"{f'{n}-lane qps':>14}{'speedup':>10}" for n in counts
    ))
    for (bench, client), per in table.items():
        line = f"{f'{bench} [{client}]':<{label_w}}"
        for n in counts:
            qps, speedup = per.get(n, (0.0, "-"))
            line += f"{qps:>14.1f}{speedup:>10}"
        print(line)
    # One build per served (workload, pass): both clients and every lane
    # count reuse the cached callable.
    print(
        f"# callable cache: {engine.cache.misses - misses0} misses across "
        f"{len(args.clients)} clients x {len(counts)} lane counts "
        f"({engine.cache.hits} hits total)",
        file=sys.stderr,
    )
    print()
    if "threaded" in args.clients:
        print("# note: co-location forces the single-threaded client (tenants "
              "alternate submissions); ignoring --clients threaded for the "
              "interference table", file=sys.stderr)
    print(f"{'pair (tenant row)':<44}{'p50_us':>10}{'qps':>10}{'slowdown':>10}")
    for name, us, derived in colocation_rows(
        preset=args.preset, names=tuple(args.names), duration_s=args.duration,
        engine=engine, impl=args.impl, device=args.device,
    ):
        fields = parse_derived(derived)
        label = name.removeprefix("fig_concurrency.colocate.")
        print(
            f"{fields.get('pair', '?') + ' / ' + label:<44}"
            f"{us:>10.1f}{float(fields.get('qps', 0)):>10.1f}"
            f"{fields.get('slowdown', '-'):>10}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
