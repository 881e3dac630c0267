"""Distributed load-generation figure: offered-QPS scaling, 1 against N
client processes.

Counterpart of ``benchmarks/fig_dist.py``. One Python process can issue
only so many requests a second: past that ceiling, raising the offered QPS
raises p99 but not throughput. The figure sweeps offered load for a
single in-process client (the ``client=threaded`` ceiling-finder) and for N
client processes (``ServeSpec.client_procs``, ``repro_torch.dist``), all
replaying seeded Poisson schedules against the same workload, and reports
the achieved-QPS curve per process count beside the single-process
ceiling.

The merged *schedule* always offers the target QPS (the
``SeedSequence.spawn`` split keeps the Poisson process), so what scales
with processes is what is *achieved*. On the CPU what limits N processes
is the host's cores. On one card it is also the card: each process holds
its own CUDA context, and without MPS the contexts are time-sliced, their
kernels never running at the same time. The JSON records ``cpu_count``
and the card's name and power limit, so the two regimes are never
conflated.

As a section (``python -m repro_torch.benchmarks.run --sections fig_dist``)
it emits the standard CSV rows; as a script it renders the scaling table,
and ``--json PATH`` also writes the curve:

    PYTHONPATH=src python -m repro_torch.benchmarks.fig_dist --json dist.json
"""

from __future__ import annotations

import json
import os
import sys

from repro_torch.benchmarks.common import Row, parse_derived, record_rows
from repro_torch.core.engine import Engine
from repro_torch.core.plan import ServeSpec
from repro_torch.core.suite import run_suite

DEFAULT_NAME = "pathfinder"
# procs=1 is the in-process threaded client (the ceiling); procs>1 go
# through repro_torch.dist. The offered points bracket the single-process
# ceiling: one under, one near, one far past.
DEFAULT_PROCS = (1, 2, 4)
DEFAULT_QPS = (2_000.0, 8_000.0, 20_000.0)
FAST = dict(iters=1, warmup=0, include_backward=False, verbose=False)


def rows(
    preset: int = 0,
    name: str = DEFAULT_NAME,
    procs=DEFAULT_PROCS,
    qps_points=DEFAULT_QPS,
    duration_s: float = 0.75,
    concurrency: int = 16,
    lanes: int = 4,
    seed: int = 0,
    engine: Engine | None = None,
    *,
    impl: str = "torch",
    device: str = "cuda",
) -> list[Row]:
    """One row per (process count, offered QPS) point. ``procs == 1`` is
    the single-process threaded client; ``procs > 1`` spawns that many
    client processes through the dist launcher."""
    engine = engine if engine is not None else Engine()
    out: list[Row] = []
    for n in procs:
        for qps in qps_points:
            serve = ServeSpec(
                mode="open", qps=qps, duration_s=duration_s,
                concurrency=concurrency, lanes=lanes,
                client="threaded" if n == 1 else "single",
                client_procs=0 if n == 1 else n,
            )
            records = run_suite(
                names=[name], preset=preset, serve=serve, seed=seed, engine=engine,
                impl=impl, device=device, **FAST,
            )

            def extra(r, n=n, qps=qps):
                proc_qps = ",".join(f"{q:.0f}" for q in (r.proc_qps or ()))
                return (
                    f"procs={n};offered_qps={qps:.0f};"
                    f"qps={r.achieved_qps:.1f};"
                    f"p50_us={r.latency_p50_us:.1f};"
                    f"p99_us={r.latency_p99_us:.1f};"
                    + (f"proc_qps={proc_qps};" if proc_qps else "")
                )

            out.extend(
                (f"{nm}.procs{n}.q{qps:.0f}", us, derived)
                for nm, us, derived in record_rows("fig_dist", records, extra)
            )
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", type=int, default=0)
    ap.add_argument("--name", default=DEFAULT_NAME)
    ap.add_argument("--procs", nargs="*", type=int, default=list(DEFAULT_PROCS),
                    help="client process counts; 1 = the in-process threaded "
                         "client (the single-process ceiling)")
    ap.add_argument("--qps", nargs="*", type=float, default=list(DEFAULT_QPS),
                    help="offered-QPS points, the same for every process count")
    ap.add_argument("--duration", type=float, default=0.75)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", choices=("torch", "kernel"), default="torch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the scaling curve as JSON")
    ap.add_argument("--cache-dir", type=str, default=None,
                    help="the tune sidecar's directory, shared with the client "
                         "processes")
    args = ap.parse_args(argv)

    engine = Engine(cache_dir=args.cache_dir)
    try:
        table = rows(
            preset=args.preset, name=args.name, procs=tuple(args.procs),
            qps_points=tuple(args.qps), duration_s=args.duration,
            concurrency=args.concurrency, lanes=args.lanes, seed=args.seed,
            engine=engine, impl=args.impl, device=args.device,
        )
    except ValueError as e:  # bad selection, no card: configuration, not a crash
        print(f"fig_dist: {e}", file=sys.stderr)
        return 2
    pts = []
    for _name, _us, derived in table:
        f = parse_derived(derived)
        if "qps" not in f:
            continue
        pts.append({
            "procs": int(f["procs"]),
            "offered_qps": float(f["offered_qps"]),
            "achieved_qps": float(f["qps"]),
            "p50_us": float(f["p50_us"]),
            "p99_us": float(f["p99_us"]),
            "proc_qps": [float(q) for q in f["proc_qps"].split(",")]
            if "proc_qps" in f else None,
        })
    if not pts:
        print(f"fig_dist: no ok serve records out of {len(table)} rows; "
              "see stderr for per-benchmark errors", file=sys.stderr)
        return 1

    best: dict[int, float] = {}
    for p in pts:
        best[p["procs"]] = max(best.get(p["procs"], 0.0), p["achieved_qps"])
    ceiling = best.get(1)
    if ceiling:
        print(f"# single-process ceiling: {ceiling:.0f} qps (cpu_count={os.cpu_count()})",
              file=sys.stderr)
    print(f"{'procs':<7}{'offered':>10}{'achieved':>10}{'p50_us':>10}"
          f"{'p99_us':>12}{'vs 1-proc':>11}")
    for p in pts:
        ratio = f"{p['achieved_qps'] / ceiling:>10.2f}x" if ceiling else f"{'-':>11}"
        print(f"{p['procs']:<7d}{p['offered_qps']:>10.0f}{p['achieved_qps']:>10.1f}"
              f"{p['p50_us']:>10.1f}{p['p99_us']:>12.1f}{ratio}")
    if engine.disk_cache is not None:
        print(f"# {engine.disk_cache.summary()}", file=sys.stderr)
    if args.json:
        import torch

        from repro_torch.core.results import gpu_name_and_power_limit

        cuda = args.device == "cuda"
        payload = {
            "kind": "fig_dist",
            "device": args.device,
            "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
            "gpu_power_limit": gpu_name_and_power_limit() if cuda else None,
            "torch_version": torch.__version__,
            "cpu_count": os.cpu_count(),
            "name": args.name,
            "impl": args.impl,
            "duration_s": args.duration,
            "concurrency": args.concurrency,
            "lanes": args.lanes,
            "seed": args.seed,
            "points": pts,
            "single_process_ceiling_qps": ceiling,
            "scaling_vs_single_process": {
                str(n): round(q / ceiling, 3) for n, q in sorted(best.items())
            } if ceiling else None,
        }
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
