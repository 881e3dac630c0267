"""The suite runner — a thin CLI over the staged execution engine.

Counterpart of ``repro/core/suite.py``, main path only. ``run_suite``
assembles an :class:`~repro_torch.core.plan.ExecutionPlan` (selection by
level / name / tag / domain, preset + overrides, passes, iters / warmup / seed, timing
window, implementation, device) and hands it to an
:class:`~repro_torch.core.engine.Engine`: the module's shared
:data:`DEFAULT_ENGINE` unless the caller gives one or a ``cache_dir``, so a
workload built for one call is reused by every later call. Output is a CSV table on stdout
plus optional JSON and streaming JSONL reports.

``--device`` defaults to ``cuda``. Without a CUDA device the run stops with
exit 2 and the reason; it never carries on on the CPU unless ``--device
cpu`` asks for it. ``--impl kernel`` times the hand-written kernels for the
workloads that declare one; on the CPU their plain versions run and the
rows say so (``impl_interpret``). ``--tune`` sweeps each kernel's tiles
before compiling and times the winner (``tuned_params``, ``tune_trials``,
``tune_trials_us`` in the row); ``--cache-dir`` keeps the winners on disk,
so a warm tuned run performs zero trials, and the CLI prints the cache's
counters on stderr.

Placement flags, the reference's: ``--devices N`` runs on the first N
devices, ``--placement {replicate,shard}`` picks what each device gets
(full copies, or the inputs split along each workload's ``batch_dims``),
and ``--scale-devices 1,2,4`` sweeps the selection across device counts,
one record per (benchmark, pass, count) with ``scaling_efficiency`` on the
multi-device rows. The devices are the ranks of a ``torch.distributed``
world, one process a device, started by ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.core.suite ...``; NCCL on ``cuda``, gloo on ``cpu``); rank 0
prints the table and writes the reports. Without ``torchrun`` one device is
available, and a plan asking for more exits 2 naming the count.

Serving flags, the reference's: ``--serve {open,closed}`` serves every
selected workload under generated load after measuring it (``--qps``
open-loop arrival rate, ``--concurrency`` in-flight cap, ``--lanes``
dispatch lanes, ``--serve-duration`` seconds); ``--serve-client
{single,threaded}`` picks the host's issue architecture; ``--slo-us`` adds
a latency SLO and ``goodput_qps``; ``--colocate NAME`` serves each
workload against a partner and records both slowdowns. Mixed-shape
serving: ``--serve-mix PRESET[/PARAM=VALUE...][@WEIGHT],...`` draws each
open-loop request's shape from a weighted mix, ``--serve-dispatch
{lanes,loop,batched,dynamic}`` picks how requests map onto device calls
(``dynamic``, the continuous batcher, coalesces a bucket's queue into a
``torch.vmap`` call of up to ``--max-batch`` requests under
``--batch-latency-budget`` microseconds), and ``--serve-trace PATH`` saves
the arrival and shape stream, or replays it when the file exists.
``--client-procs N`` (distributed load generation, open loop) serves each
row from N client processes on ``--device``, each replaying its seeded share
of the stream; the rows carry ``client_procs`` and the per-process
``proc_qps``, and the clients' summed cache counters print on stderr as
``# dist-cache[N procs]: ...``. ``--trace-out PATH`` records the run with a
tracer (a span a stage, an event a served request and a batch) and writes
it as Chrome trace-event JSON, printing the event count on stderr; the
counter snapshot lands in the JSONL metadata.

Exit codes: 0 every row ok, 1 error rows present (or a malformed
``--serve-mix``, as in the reference), 2 a configuration error (unknown
name, bad override, no such device, a serve flag without ``--serve``).

    PYTHONPATH=src python -m repro_torch.core.suite --names gemm_bf16_nn \\
        softmax --preset 4 --impl kernel --no-backward --jsonl run.jsonl
    PYTHONPATH=src python -m repro_torch.core.suite --names gemm_f32_tn \\
        --preset 4 --impl kernel --no-backward --tune --cache-dir /tmp/tune
    PYTHONPATH=src python -m repro_torch.core.suite --names gemm_bf16_nn \\
        --preset 4 --impl kernel --no-backward --serve open --qps 2000 \\
        --serve-mix "4@1,4/n=1024@2" --serve-dispatch dynamic --max-batch 4
    PYTHONPATH=src python -m repro_torch.core.suite --names gemm_bf16_nn \\
        --preset 4 --impl kernel --no-backward --serve open --qps 2000 \\
        --client-procs 2 --cache-dir /tmp/cache --trace-out run.trace.json
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.core.suite --device cpu --impl kernel --levels 1 \\
        --placement shard --scale-devices 1,2,4 --no-backward
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Mapping, Sequence

from repro_torch.core.engine import Engine
from repro_torch.core.plan import (
    DEVICES,
    IMPLS,
    PLACEMENT_MODES,
    SERVE_CLIENTS,
    SERVE_DISPATCH,
    SERVE_MODES,
    ExecutionPlan,
    Placement,
    PlanError,
    ServeSpec,
    ShapeBucket,
)
from repro_torch.core.results import BenchmarkRecord, to_csv_lines
from repro_torch.obs import Tracer
from repro_torch.runtime import sharding

__all__ = ["run_suite", "main", "DEFAULT_ENGINE"]

# Shared across run_suite callers (figure drivers, examples, tests), as the
# reference's: a workload built for one section is reused by every later
# one. Building an Engine touches no device.
DEFAULT_ENGINE = Engine()


def run_suite(
    *,
    levels: Sequence[int] = (0, 1, 2),
    names: Sequence[str] | None = None,
    tags: Sequence[str] | None = None,
    domains: Sequence[str] | None = None,
    preset: int = 0,
    overrides: Mapping[str, Mapping[str, Any]] | None = None,
    iters: int = 5,
    warmup: int = 2,
    include_backward: bool = True,
    seed: int = 0,
    timing_window: int = 4,
    impl: str = "torch",
    tune: bool = False,
    device: str = "cuda",
    devices: int = 1,
    placement: str = "replicate",
    scale_devices: Sequence[int] | None = None,
    serve: ServeSpec | None = None,
    report_path: str | None = None,
    jsonl_path: str | None = None,
    verbose: bool = True,
    engine: Engine | None = None,
    cache_dir: str | None = None,
) -> list[BenchmarkRecord]:
    """Run a plan of these parameters on ``engine``, on a new engine with
    its tune winners under ``cache_dir`` (give one or the other), or else on
    :data:`DEFAULT_ENGINE`."""
    if engine is not None and cache_dir is not None:
        raise ValueError("pass engine or cache_dir, not both: the engine owns its disk cache")
    plan = ExecutionPlan(
        levels=tuple(levels),
        names=tuple(names) if names is not None else None,
        tags=tuple(tags) if tags is not None else None,
        domains=tuple(domains) if domains is not None else None,
        preset=preset,
        overrides=overrides or {},
        include_backward=include_backward,
        iters=iters,
        warmup=warmup,
        seed=seed,
        timing_window=timing_window,
        impl=impl,
        tune=tune,
        device=device,
        placement=Placement(devices=devices, mode=placement),
        device_sweep=tuple(scale_devices) if scale_devices is not None else None,
        serve=serve,
    )
    if engine is None:
        engine = Engine(cache_dir=cache_dir) if cache_dir is not None else DEFAULT_ENGINE
    result = engine.run(
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


def _parse_scale_devices(text: str | None) -> tuple[int, ...] | None:
    """``"1,2,4"`` -> (1, 2, 4)."""
    if text is None:
        return None
    try:
        counts = tuple(int(part) for part in text.split(",") if part.strip())
    except ValueError:
        raise SystemExit(
            f"bad --scale-devices {text!r}; expected comma-separated ints, e.g. 1,2,4"
        ) from None
    if not counts:
        raise SystemExit(f"bad --scale-devices {text!r}; no device counts given")
    return counts


def _parse_mix(text: str) -> tuple[ShapeBucket, ...]:
    """``"0@2,0/cols=256@1"`` -> weighted ShapeBuckets.

    Grammar per comma-separated bucket: ``PRESET[/PARAM=VALUE...][@WEIGHT]``
    (weight defaults to 1.0; values parse as int, then float, then str, the
    reference's ``--serve-mix`` convention). A malformed mix exits with its
    message (exit 1), as the reference's does.
    """

    def parse_value(value: str) -> Any:
        try:
            return int(value)
        except ValueError:
            try:
                return float(value)
            except ValueError:
                return value

    buckets = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        weight = 1.0
        if "@" in part:
            part, w = part.rsplit("@", 1)
            try:
                weight = float(w)
            except ValueError:
                raise SystemExit(
                    f"bad --serve-mix weight {w!r} in {text!r}; expected a number"
                ) from None
        fields = part.split("/")
        try:
            preset = int(fields[0])
        except ValueError:
            raise SystemExit(
                f"bad --serve-mix bucket {part!r} in {text!r}; expected "
                "PRESET[/PARAM=VALUE...][@WEIGHT], e.g. 0@2,1/cols=256@1"
            ) from None
        overrides = []
        for field in fields[1:]:
            if "=" not in field:
                raise SystemExit(
                    f"bad --serve-mix override {field!r} in {text!r}; expected PARAM=VALUE"
                )
            k, v = field.split("=", 1)
            overrides.append((k, parse_value(v)))
        buckets.append(ShapeBucket(preset=preset, weight=weight, overrides=tuple(overrides)))
    if not buckets:
        raise SystemExit(f"bad --serve-mix {text!r}; no buckets given")
    return tuple(buckets)


def _parse_serve(args) -> ServeSpec | None:
    """A ServeSpec when any serving flag was used (``--colocate`` alone
    implies a closed-loop serve), else None. Serve-tuning flags without a
    serve mode are a configuration error, not silently dropped."""
    tuning = {
        "--qps": args.qps,
        "--concurrency": args.concurrency,
        "--lanes": args.lanes,
        "--serve-duration": args.serve_duration,
        "--serve-client": args.serve_client,
        "--slo-us": args.slo_us,
        "--serve-dispatch": args.serve_dispatch,
        "--serve-mix": args.serve_mix,
        "--serve-trace": args.serve_trace,
        "--batch-latency-budget": args.batch_latency_budget,
        "--max-batch": args.max_batch,
        "--client-procs": args.client_procs,
    }
    if args.serve is None and args.colocate is None:
        stray = [flag for flag, value in tuning.items() if value is not None]
        if stray:
            raise PlanError(
                f"{', '.join(stray)} require --serve {{open,closed}} or --colocate NAME"
            )
        return None
    spec = ServeSpec()  # defaults live on the dataclass, not the CLI

    def given(value, default):
        return value if value is not None else default

    return ServeSpec(
        mode=args.serve or "closed",
        qps=given(args.qps, 50.0),
        concurrency=given(args.concurrency, spec.concurrency),
        lanes=given(args.lanes, spec.lanes),
        duration_s=given(args.serve_duration, spec.duration_s),
        colocate=args.colocate,
        client=given(args.serve_client, spec.client),
        slo_us=args.slo_us,
        dispatch=given(args.serve_dispatch, spec.dispatch),
        mix=_parse_mix(args.serve_mix) if args.serve_mix is not None else None,
        trace=args.serve_trace,
        batch_budget_us=given(args.batch_latency_budget, spec.batch_budget_us),
        max_batch=given(args.max_batch, spec.max_batch),
        client_procs=given(args.client_procs, spec.client_procs),
    )


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run the Mirovia/Altis suite (PyTorch port)")
    ap.add_argument("--levels", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--names", type=str, nargs="*", default=None)
    ap.add_argument("--tags", type=str, nargs="*", default=None)
    ap.add_argument("--domains", type=str, nargs="*", default=None)
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
    ap.add_argument("--tune", action="store_true",
                    help="sweep each kernel's tile candidates before compiling "
                         "(windowed-timer trials); the winner joins the row "
                         "(tuned_params) and persists in --cache-dir")
    ap.add_argument("--cache-dir", type=str, default=None,
                    help="keep tune winners here, versioned by the port's "
                         "source, torch, CUDA and the device, so warm --tune "
                         "runs skip the sweep")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where to run (default cuda; a missing CUDA device "
                         "is an error, never a silent CPU run)")
    ap.add_argument("--devices", type=int, default=1,
                    help="run on the first N devices (ranks of the torchrun world)")
    ap.add_argument("--placement", choices=PLACEMENT_MODES, default="replicate",
                    help="what multi-device runs put on each device: full copies "
                         "(replicate) or batch_dims-partitioned inputs (shard)")
    ap.add_argument("--scale-devices", type=str, default=None, metavar="N1,N2,...",
                    help="device-scaling sweep, e.g. 1,2,4: one record per "
                         "(benchmark, pass, count)")
    ap.add_argument("--serve", choices=SERVE_MODES, default=None,
                    help="serve each selected workload under load after measuring "
                         "it: open-loop arrivals at --qps or closed-loop at "
                         "--concurrency")
    ap.add_argument("--qps", type=float, default=None,
                    help="open-loop arrival rate (requests/s, default 50)")
    ap.add_argument("--concurrency", type=int, default=None,
                    help="closed-loop in-flight requests (also the open-loop "
                         "in-flight cap; default 4)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="dispatch lanes (HyperQ-style work queues, default 2)")
    ap.add_argument("--serve-duration", type=float, default=None, metavar="SECONDS",
                    help="serving duration per workload (default 2.0)")
    ap.add_argument("--serve-client", choices=SERVE_CLIENTS, default=None,
                    help="host issue architecture: 'single' dispatches every lane "
                         "from one thread (default); 'threaded' gives each lane "
                         "its own issuing thread (all on the device's current "
                         "stream) and records dispatch overhead and per-lane QPS")
    ap.add_argument("--slo-us", type=float, default=None, metavar="US",
                    help="latency SLO in microseconds; rows gain goodput_qps")
    ap.add_argument("--client-procs", type=int, default=None, metavar="N",
                    help="distributed load generation (open loop): N client "
                         "processes on --device, each replaying its seeded share "
                         "of the arrival stream; rows carry client_procs and "
                         "per-process proc_qps (share --cache-dir with them)")
    ap.add_argument("--serve-dispatch", choices=SERVE_DISPATCH, default=None,
                    help="how requests map onto device calls: N-lane dispatch "
                         "(lanes, default), or the mixed-shape paths: sync "
                         "per request (loop), a fixed-width torch.vmap call that "
                         "waits to fill (batched), the continuous batcher (dynamic)")
    ap.add_argument("--serve-mix", type=str, default=None, metavar="P[/K=V...][@W],...",
                    help="weighted request-shape mix for open-loop serving, e.g. "
                         "'0@2,1@1' or '0@3,0/cols=256@1'")
    ap.add_argument("--serve-trace", type=str, default=None, metavar="PATH",
                    help="replayable JSONL arrival and shape trace: replayed when "
                         "PATH exists, else the generated schedule is saved there")
    ap.add_argument("--batch-latency-budget", type=float, default=None, metavar="US",
                    help="dynamic batcher wait budget in microseconds (default "
                         "2000)")
    ap.add_argument("--max-batch", type=int, default=None, metavar="N",
                    help="largest batch width (default 8); dynamic uses powers "
                         "of two up to N per bucket, batched exactly N")
    ap.add_argument("--colocate", type=str, default=None, metavar="NAME",
                    help="co-locate every served workload with this benchmark "
                         "and record slowdown against isolation (implies "
                         "--serve closed)")
    ap.add_argument("--no-backward", action="store_true")
    ap.add_argument("--report", type=str, default=None, help="JSON report path")
    ap.add_argument("--jsonl", type=str, default=None,
                    help="streaming JSONL report path (with run metadata)")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON file (Perfetto or "
                         "chrome://tracing): a span a stage on the engine "
                         "track, a served request a lane, a batch a queue "
                         "(host clock)")
    args = ap.parse_args(argv)
    try:
        sharding.init_distributed(args.device)  # a torchrun world, else one process
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    tracer = Tracer() if args.trace_out else None
    # One engine an invocation (not DEFAULT_ENGINE): the run's counters and
    # its disk cache's summary are its own, as a process's would be.
    engine = Engine(cache_dir=args.cache_dir, tracer=tracer)
    try:
        records = run_suite(
            levels=args.levels,
            names=args.names,
            tags=args.tags,
            domains=args.domains,
            preset=args.preset,
            overrides=_parse_overrides(args.override),
            iters=args.iters,
            warmup=args.warmup,
            seed=args.seed,
            timing_window=args.timing_window,
            impl=args.impl,
            tune=args.tune,
            device=args.device,
            devices=args.devices,
            placement=args.placement,
            scale_devices=_parse_scale_devices(args.scale_devices),
            serve=_parse_serve(args),
            include_backward=not args.no_backward,
            report_path=args.report,
            jsonl_path=args.jsonl,
            verbose=False,
            engine=engine,
        )
    except (PlanError, ValueError) as e:
        # Bad selection, placement or device count: a configuration error.
        print(f"error: {e}", file=sys.stderr)
        print(f"available devices: {sharding.available_devices()} (device={args.device})",
              file=sys.stderr)
        return 2
    if sharding.rank() != 0:
        return 0  # rank 0 reports for the world
    for line in to_csv_lines(records):
        print(line)
    if engine.disk_cache is not None:
        # A disk cache that never hits is otherwise invisible from the CLI.
        print(f"# {engine.disk_cache.summary()}", file=sys.stderr)
    if tracer is not None:
        n = tracer.export_chrome(args.trace_out)
        print(f"# trace: {n} spans -> {args.trace_out} (load in https://ui.perfetto.dev "
              "or chrome://tracing)", file=sys.stderr)
    errors = [r for r in records if r.status != "ok"]
    for r in errors:
        print(f"# ERROR {r.name}: {r.error}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
