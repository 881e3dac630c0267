"""Staged execution engine: build → place → [tune] → compile → measure →
characterize → report.

Counterpart of ``repro/core/engine.py``, main path only. For every selected
benchmark the engine runs the stages:

- **build**: instantiate the workload from the spec at the plan's preset
  (plus Rodinia-style overrides) and make its inputs from the plan's seed.
- **place**: the effective placement from shapes alone
  (``_resolve_placement``: a ``shard`` request degrades to ``replicate``
  for workloads that opt out of ``batch_dims`` or whose dims do not divide,
  and host-transfer rows run on one device), then the inputs go where it
  says. On one device ``harness.commit_args`` moves every input to the
  plan's device once, before any timed call; host-transfer workloads
  (``meta["no_jit"]``, the bus-speed rows) time the transfer itself, so
  their inputs stay where ``make_inputs`` put them, except the positions
  ``meta["device_args"]`` names (a destination buffer, a tensor to read
  back). On n devices ``runtime/sharding.py::place_args`` makes each input
  a DTensor on the first n ranks' mesh, sharded or replicated, and the
  kernel ops take their sharding rules (``kernels/ops.py``).
- **tune** (only for kernel passes of plans with ``tune=True``): sweep the
  kernel's ``tune_space()`` in order, compiling each candidate through the
  callable cache and timing it with the windowed timer; the winner's
  parameters join the cache key and go to ``force_impl``, and persist in
  the disk cache (``core/hlocache.py``, ``cache_dir``), so a warm ``--tune``
  run restores the winner and performs zero trials. A candidate the kernel
  refuses before launching (:class:`~repro_torch.kernels.ops.TileRefused`,
  a tile its routed entry does not compile) is skipped and counted; a
  refused first candidate, the kernel's defaults, fails the row.
- **compile**: bind the pass's function to its implementation and make
  one first call, which builds and loads the kernels on first use. The
  bound callable goes into an in-process cache keyed like the reference's
  ``CacheKey`` — ``(name, preset, overrides, backward, device, devices,
  placement, impl, tuned-params)`` — so one engine builds each
  (pass, implementation, tile) once. The plan's ``impl`` resolves per
  workload: a kernel plan times torch for host-transfer workloads, for workloads
  that declare no kernel and for backward passes, and ``impl_fallback``
  says so (``no_jit``, ``no_kernel``, ``backward_pass``).
- **measure**: validate one output, then time the bound callable in sync
  mode (``us_per_call``) and, when ``plan.timing_window > 1``, in windowed
  mode (``us_per_call_windowed``), with CUDA events on the card. A
  host-transfer row is synchronous by construction, so its windowed columns
  stay empty.
- **characterize**: the pass's analytic roofline against the card's peaks
  for the row's dtype, memoized beside the callable. A host-transfer row
  gets none: its bytes cross the host bus, and HBM's rate is no bound for
  them.
- **serve** (only when the plan carries a
  :class:`~repro_torch.core.plan.ServeSpec`, forward passes only): serve
  the measure stage's bound callable under generated load through
  ``repro_torch.serve`` — open-loop arrivals at a target QPS or closed-loop
  at fixed concurrency, across N dispatch lanes, issued by the spec's
  client (``single``: every lane from this thread; ``threaded``: a thread a
  lane, all on the device's current stream) — and fold the latency
  percentiles, achieved QPS and truncation flag into the record. With
  ``colocate`` the workload is also served against a partner on split
  lanes, and both rows carry their p50 slowdown against isolation. With a
  mix of :class:`~repro_torch.core.plan.ShapeBucket` s (or a trace, or a
  batcher dispatch) the stage builds one callable per (bucket, batch
  width), width w being ``torch.vmap`` of the pass's function over w
  requests' stacked inputs (kernel routes reach their batching rules in
  ``kernels/ops.py``), and serves the schedule through
  ``serve/batcher.py``, recording occupancy, padding waste and per-bucket
  percentiles.
- **report**: a :class:`BenchmarkRecord`, streamed to the JSONL writer as
  it is produced.

The reference picks its implementation while JAX traces, so entering
``ops.force_impl`` around ``lower`` fixes it for every later call. PyTorch
dispatches on each call, so the bound callable enters ``force_impl`` on
*every* call — the first call, the validation call, the warm-up, the
timed and the windowed calls — and a kernel row times the kernel in all of
them. Workloads that declare a kernel are pinned both ways: ``kernel``
forces the kernel route, ``torch`` forces the plain oracle.

At the start of a run both TF32 switches are turned off and recorded in
the run's metadata: f32 rows are true f32.

With ``client_procs`` the serve stage hands the row to
``repro_torch.dist.launcher.run_distributed``: N client processes, each
building the workload through its own engine on the plan's device and
replaying its share of one seeded open-loop stream; the launcher merges
their completions into one set of statistics with per-process QPS.

Tracing (``Engine(tracer=...)``, ``repro_torch.obs``): every stage is one
span, recorded from the same ``perf_counter`` pair that fills the record's
``stage_timings_us``, so the two are equal; the tune stage adds one event a
trial and the ``tune.trials`` counter; the serve stage adds one event a
request (``serve`` track, a tid a lane) and one a dispatched batch
(``batcher`` track), built afterwards from the stamps the lanes took; and
the counter snapshot lands in ``RunMetadata.counters``. The spans are host
clock: the measure stage's span closes after its CUDA events have been
synchronised, and no span is a device time. The timer's loops
(``core/harness.py``) consult no tracer.

**Device sweeps.** ``plan.device_sweep`` runs the selection once a device
count, ascending, into one record per (benchmark, pass, count); each
multi-device row carries ``scaling_efficiency`` against the same run's
1-device row (speedup over devices), and each count's callable-cache
traffic is a :class:`SweepStat`. The devices are the ranks of a
``torch.distributed`` world, every rank running this same plan: for a
count n below the world size the first n ranks run on a sub-mesh (every
rank makes its group) while the others wait at the count's barrier; a row
whose effective placement is one device runs on rank 0 alone. Each
participating rank times its own calls, and each measurement's maximum
over the sub-group is the row's (tune trials alike, so every rank keeps
the same winner). Rank 0 alone emits records, JSONL, CSV and reports.
Outside a process group one device is available; a plan asking for more
raises :class:`PlanError` naming both counts. Serving stays on one
device: the serve stage's call counts follow the clock, and ranks whose
calls gather operands must make equal counts.

Failures are isolated per benchmark: an exception in any stage yields a
``status="error"`` record naming the stage, and the suite keeps going.
The disk cache holds the tune winners alone.

Rows that replay a captured CUDA graph (``core/graphs.py``) key it by
addresses and route, not by tile: every such row's kernel has a one-entry
tune space today, so no swept row is captured. One that is must put the
candidate into its graph's key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, Callable

import torch

from repro_torch.core.harness import (
    CompiledInfo,
    characterize,
    commit_args,
    empty_compiled_info,
    time_fn,
    timing_from_stats,
)
from repro_torch.core.graphs import GraphCache
from repro_torch.core.hlocache import HloDiskCache
from repro_torch.core.plan import ExecutionPlan, Placement, PlanError, ServeSpec
from repro_torch.core.registry import BenchmarkSpec, Workload, get_benchmark
from repro_torch.core.results import (
    BenchmarkRecord,
    JsonlReportWriter,
    RunMetadata,
    write_report,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import NULL_TRACER, NullTracer, Tracer, use_tracer
from repro_torch.runtime import sharding

__all__ = ["CompileCache", "Engine", "RunResult", "SweepStat", "bind_impl"]

# (name, preset, frozen-overrides, backward, device, devices, placement,
#  impl, frozen-tuned-params — () when the pass was not tuned). Mixed-shape
# serving appends ("vmap", width) for batch widths > 1; a bucket's width-1
# callable at the plan's own preset and overrides shares the measure
# stage's key (and its callable).
CacheKey = tuple[str, int, tuple, bool, str, int, str, str, tuple]


@dataclasses.dataclass
class _CacheEntry:
    executable: Callable[..., Any]
    info: CompiledInfo | None = None  # memoized by the characterize stage


class CompileCache:
    """In-process cache of bound callables with hit/miss counters."""

    def __init__(self) -> None:
        self._entries: dict[CacheKey, _CacheEntry] = {}
        self.hits = 0
        self.misses = 0

    def peek(self, key: CacheKey) -> _CacheEntry | None:
        """Lookup without counting a hit (callers count on actual use)."""
        return self._entries.get(key)

    def lookup(self, key: CacheKey, build: Callable[[], _CacheEntry]) -> _CacheEntry:
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry
        # Count the miss only after a successful build so a failing build
        # retried later is not counted twice.
        entry = build()
        self.misses += 1
        self._entries[key] = entry
        return entry


@dataclasses.dataclass(frozen=True)
class SweepStat:
    """Cache traffic of one device-sweep step (scaling-run diagnostics)."""

    devices: int
    misses: int
    hits: int


@dataclasses.dataclass
class RunResult:
    records: list[BenchmarkRecord]
    metadata: RunMetadata
    cache: CompileCache
    sweep_stats: list[SweepStat] = dataclasses.field(default_factory=list)

    @property
    def ok_records(self) -> list[BenchmarkRecord]:
        return [r for r in self.records if r.status == "ok"]


def bind_impl(
    fn: Callable[..., Any], workload: Workload, impl: str, params: dict | None = None
) -> Callable[..., Any]:
    """``fn`` with its implementation pinned on every call.

    Workloads that declare a kernel run each call inside
    ``ops.force_impl``: the kernel route for ``impl="kernel"``, with the
    tuned block ``params`` merged into the kernel's calls, the plain oracle
    for ``impl="torch"``. Undeclared workloads run untouched.
    """
    if workload.kernel is None:
        return fn
    mode = "kernel" if impl == "kernel" else "ref"
    params = dict(params or {})

    def call(*args):
        with kernel_ops.force_impl(mode, workload.kernel, **params):
            return fn(*args)

    return call


class Engine:
    """Executes plans. Holds the callable cache, so a long-lived engine
    reuses bound callables (and their first-call builds) across runs, and,
    given ``cache_dir``, the disk cache of tune winners shared across
    processes (distributed clients are pointed at the same directory)."""

    def __init__(
        self,
        cache: CompileCache | None = None,
        cache_dir: str | None = None,
        tracer: Tracer | NullTracer | None = None,
    ) -> None:
        self.cache = cache if cache is not None else CompileCache()
        self.cache_dir = cache_dir
        self.disk_cache = HloDiskCache(cache_dir) if cache_dir else None
        # NULL_TRACER by default: falsy, no-op, its counters swallowed; the
        # disabled cost at a guarded call site is one attribute read.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # Width-w serve calls of graph-replay workloads, captured whole.
        self._graphs = GraphCache(capacity=64)
        # Data meshes by device count; every rank makes each in one order.
        self._meshes: dict[int, Any] = {}
        # The process group of the multi-device row being run, else None.
        self._group = None

    # -- stages ------------------------------------------------------------

    def _cache_key(
        self,
        spec: BenchmarkSpec,
        plan: ExecutionPlan,
        preset: int,
        backward: bool,
        placement: Placement,
        impl: str = "torch",
        tuned_params: dict | None = None,
    ) -> CacheKey:
        return (
            spec.name,
            preset,
            tuple(sorted(plan.overrides_for(spec.name).items())),
            backward,
            plan.device,
            placement.devices,
            placement.mode,
            impl,
            tuple(sorted((tuned_params or {}).items())),
        )

    def _resolve_impl(
        self, workload: Workload, plan: ExecutionPlan, backward: bool
    ) -> tuple[str, str | None]:
        """The *effective* implementation for one (workload, pass):
        ``(impl, fallback_reason)``. A kernel plan degrades to torch — with
        the reason recorded — for host-transfer (no_jit) workloads, for
        workloads that declare no kernel and for backward passes (the
        kernels are forward programs)."""
        if plan.impl != "kernel":
            return "torch", None
        if workload.meta.get("no_jit"):
            return "torch", "no_jit"
        if workload.kernel is None:
            return "torch", "no_kernel"
        if workload.kernel not in kernel_ops.KERNEL_OPS:
            raise ValueError(
                f"workload {workload.name!r} declares kernel={workload.kernel!r}, "
                f"not a known op: {sorted(kernel_ops.KERNEL_OPS)}"
            )
        if backward:
            return "torch", "backward_pass"
        return "kernel", None

    def _stage_build(
        self, spec: BenchmarkSpec, plan: ExecutionPlan, preset: int
    ) -> tuple[Workload, tuple]:
        workload = spec.build_preset(preset, **plan.overrides_for(spec.name))
        return workload, workload.make_inputs(plan.seed)

    def _resolve_placement(self, workload: Workload, args: tuple,
                           requested: Placement) -> Placement:
        """The *effective* placement, from shapes alone (no transfers):
        shard requests degrade to replicate for workloads that opt out of
        ``batch_dims`` (or whose dims do not divide), and no_jit host-
        transfer workloads always run, and are recorded, on one device."""
        if workload.meta.get("no_jit") or requested.devices == 1:
            return Placement(devices=1, mode="replicate")
        if requested.mode == "shard" and sharding.shard_applies(args, workload,
                                                                requested.devices):
            return requested
        return Placement(devices=requested.devices, mode="replicate")

    def _mesh(self, devices: int):
        """The data mesh over the first ``devices`` ranks (made once; a
        collective, so every rank asks for it in the same order)."""
        if devices not in self._meshes:
            self._meshes[devices] = sharding.data_mesh(devices)
        return self._meshes[devices]

    def _stage_place(self, workload: Workload, args: tuple, plan: ExecutionPlan,
                     placement: Placement | None = None) -> tuple:
        """Put the inputs where the effective ``placement`` (one device by
        default) says. On one device: move them to the plan's device once,
        so no timed call pays a host copy; a no_jit workload's inputs stay
        on the host, but for the positions its ``meta["device_args"]``
        names. On several (``sharding.place_args``): ``shard`` makes
        DTensors on the data mesh; ``replicate`` gives each rank its own
        full copy of rank 0's inputs, so every rank runs the whole function
        on plain tensors."""
        if placement is not None and placement.devices > 1:
            placed, mode = sharding.place_args(args, workload, self._mesh(placement.devices),
                                               placement.mode)
            if mode != placement.mode:
                raise RuntimeError(f"{workload.name}: placed {mode!r}, resolved "
                                   f"{placement.mode!r}")
            if mode == "replicate":
                placed = tuple(a.to_local() if isinstance(a, torch.Tensor) else a
                               for a in placed)
            return placed
        if not workload.meta.get("no_jit"):
            return commit_args(args, plan.device)
        on_device = workload.meta.get("device_args", ())
        return tuple(commit_args((a,), plan.device)[0] if i in on_device else a
                     for i, a in enumerate(args))

    def _stage_compile(
        self,
        spec: BenchmarkSpec,
        workload: Workload,
        args: tuple,
        plan: ExecutionPlan,
        preset: int,
        backward: bool,
        placement: Placement,
        impl: str = "torch",
        tuned_params: dict | None = None,
    ) -> _CacheEntry:
        fn = workload.fn_bwd if backward else workload.fn
        if backward and fn is None:
            raise ValueError(f"workload {workload.name!r} has no backward pass")
        key = self._cache_key(spec, plan, preset, backward, placement, impl, tuned_params)
        return self.cache.lookup(key, functools.partial(
            self._bind_first_call, fn, workload, impl, tuned_params, args, plan.device))

    def _stage_tune(
        self,
        spec: BenchmarkSpec,
        workload: Workload,
        args: tuple,
        plan: ExecutionPlan,
        preset: int,
        backward: bool,
        placement: Placement,
        impl: str,
    ) -> tuple[dict | None, int | None, float | None, int]:
        """Sweep the kernel's ``tune_space()`` -> (winner, trials, wall µs,
        refused candidates).

        Runs between place and compile, only for kernel passes of tuning
        plans; every other pass returns ``(None, None, None, 0)`` and costs
        nothing. Candidates are swept in ``tune_space()`` order, each
        compiled through the callable cache under its full key (the
        winner's later compile stage is a hit) and timed with the windowed
        timer (``_time_tune_trial``). Ties keep the earliest candidate, so a
        deterministic timer gives a deterministic winner. A one-entry space
        wins at zero trials. A candidate the kernel refuses before launching
        (``TileRefused``) is skipped and counted, never timed and never the
        winner; a refused first candidate, the kernel's defaults, raises, as
        does any other error. The winner persists in the disk cache under
        the *base* key (parameters left out: the lookup must not need the
        answer), so a warm run restores it at zero trials. On several
        devices a trial's time is the slowest rank's, so every rank picks
        the same winner.
        """
        if impl != "kernel" or not plan.tune:
            return None, None, None, 0
        space = kernel_ops.tune_space(workload.kernel) or ({},)
        if len(space) == 1:
            return dict(space[0]), 0, 0.0, 0
        base_key = self._cache_key(spec, plan, preset, backward, placement, impl)
        if self.disk_cache is not None:
            won = self.disk_cache.load_tuned(base_key, candidates=space)
            if won is not None:
                return won, 0, 0.0, 0
        best_us: float | None = None
        best: dict = {}
        trials = refused = 0
        # The sum of the timed candidates' wall spans: each trial's pair
        # (c0, c1) is added here and is its trace event, so the record's
        # tune_trials_us and the trace cannot disagree.
        trials_us = 0.0
        tracer = self.tracer
        for i, cand in enumerate(space):
            c0 = time.perf_counter()
            try:
                entry = self._stage_compile(
                    spec, workload, args, plan, preset, backward, placement, impl, dict(cand)
                )
            except kernel_ops.TileRefused:
                if i == 0:
                    raise
                refused += 1
                continue
            mean_us = self._time_tune_trial(entry, args, plan)
            if self._group is not None:
                mean_us = sharding.reduce_max([mean_us], self._group)[0]
            c1 = time.perf_counter()
            trials_us += (c1 - c0) * 1e6
            trials += 1
            if tracer.enabled:
                tracer.event(
                    "tune.trial", t_start=c0, t_end=c1, track="engine",
                    bench=spec.name, params=dict(cand), mean_us=mean_us,
                )
                tracer.counters.inc("tune.trials")
            if best_us is None or mean_us < best_us:
                best_us, best = mean_us, dict(cand)
        if self.disk_cache is not None:
            self.disk_cache.store_tuned(base_key, best, trials, trials_us)
        return best, trials, trials_us, refused

    def _time_tune_trial(self, entry: _CacheEntry, args: tuple, plan: ExecutionPlan) -> float:
        """One candidate's figure of merit (mean µs a call, windowed). A
        seam: tests replace it to pin the sweep's timing."""
        mean_us, _ = time_fn(
            entry.executable, args,
            iters=min(plan.iters, 3),  # a sweep trial, not the measurement
            warmup=1, window=plan.timing_window, device=plan.device,
        )
        return mean_us

    def _stage_measure(
        self,
        workload: Workload,
        entry: _CacheEntry,
        args: tuple,
        plan: ExecutionPlan,
        backward: bool,
    ):
        out = entry.executable(*args)
        _synchronize(plan.device)
        if not backward and workload.validate is not None:
            # A sharded row validates the whole output, on every rank.
            workload.validate(_whole(out), _whole(args))
        del out
        mean, stdev = time_fn(
            entry.executable, args, iters=plan.iters, warmup=plan.warmup,
            device=plan.device,
        )
        windowed_us = None
        window = plan.timing_window
        if window > 1 and not workload.meta.get("no_jit"):
            # The sync loop above already warmed the callable. A no_jit
            # host transfer returns only when it is done, so a window of
            # them is the sync number with more noise: left empty.
            windowed_us, _ = time_fn(
                entry.executable, args, iters=plan.iters, warmup=0,
                window=window, device=plan.device,
            )
        if self._group is not None:  # the slowest rank's, measurement by measurement
            mean, stdev, windowed = sharding.reduce_max(
                [mean, stdev, -1.0 if windowed_us is None else windowed_us], self._group)
            windowed_us = None if windowed_us is None else windowed
        return timing_from_stats(
            workload, mean_us=mean, stdev_us=stdev, iters=plan.iters,
            backward=backward, windowed_us=windowed_us, window=window,
        )

    def _stage_characterize(
        self,
        workload: Workload,
        entry: _CacheEntry,
        args: tuple,
        plan: ExecutionPlan,
        backward: bool,
    ) -> CompiledInfo:
        if entry.info is None and workload.meta.get("no_jit"):
            entry.info = empty_compiled_info(workload.name)
        elif entry.info is None:
            entry.info = characterize(
                workload, args, backward=backward,
                device_name=_device_name(plan.device),
            )
        return entry.info

    # -- serving -----------------------------------------------------------

    def _trace_completions(self, completions) -> None:
        """One trace event a served request, on its dispatch lane (``serve``
        track, a tid a lane), made after the run from the stamps the lanes
        took: the serving loop itself is never instrumented."""
        tracer = self.tracer
        if not tracer.enabled:
            return
        for c in completions:
            attrs = {"index": c.index, "warmup": c.warmup}
            if c.bucket is not None:
                attrs["bucket"] = c.bucket
            tracer.event(
                "request", t_start=c.t_submit, t_end=c.t_done,
                track="serve", tid=f"lane {c.lane}", **attrs,
            )
        tracer.counters.inc("serve.requests", len(completions))

    def _trace_batches(self, report) -> None:
        """One trace event a dispatched call of a ``BatchReport`` (``batcher``
        track, a tid a bucket queue), and the flush, expiry and padding
        counters."""
        tracer = self.tracer
        if not tracer.enabled:
            return
        counters = tracer.counters
        for b in report.batches:
            tracer.event(
                f"batch[{b.width}]", t_start=b.t_dispatch, t_end=b.t_done,
                track="batcher", tid=f"queue {b.bucket}",
                width=b.width, filled=b.filled, cause=b.cause,
            )
            counters.inc("batcher.flushes")
            if b.cause == "expired":
                counters.inc("batcher.budget_expiries")
            counters.inc("batcher.dispatched_slots", b.width)
            counters.inc("batcher.padded_slots", b.width - b.filled)

    def _served(self, name: str, width: int, call: Callable[[], Any]) -> Callable[[], Any]:
        """The callable a serving run of row ``name`` makes its width-``width``
        calls through: ``call`` itself. A seam: a harness wraps it to count
        the calls each served row makes (``chip_smoke.py`` holds the launch
        counters to them)."""
        return call

    def _serve_call(self, call: Callable[[], Any], serve: ServeSpec, seed: int):
        """One isolated serving run of a bound callable, under the spec's
        client: ``single`` dispatches every lane from this thread;
        ``threaded`` gives each lane its own issuing thread fed from a
        per-lane deterministic sub-schedule, with its per-request dispatch
        overhead in the stats. Open-loop stats carry the schedule's
        ``truncated`` flag, so a capped run never claims the full target."""
        from repro_torch.serve.client import run_closed_loop_threaded, run_open_loop_threaded
        from repro_torch.serve.lanes import run_closed_loop, run_open_loop
        from repro_torch.serve.latency import stats_from_completions
        from repro_torch.serve.loadgen import open_loop_lane_schedules, open_loop_schedule

        # Fill the whole pipeline (every in-flight slot) before measuring:
        # requests into an empty window see less queueing than steady state.
        warmup = max(serve.concurrency, serve.lanes, 2)
        if serve.mode == "open":
            if serve.client == "threaded":
                lane_schedules = open_loop_lane_schedules(
                    qps=serve.qps, duration_s=serve.duration_s, n_lanes=serve.lanes,
                    seed=seed, warmup=warmup,
                )
                result = run_open_loop_threaded(
                    call, lane_schedules, concurrency=serve.concurrency
                )
                self._trace_completions(result.completions)
                return stats_from_completions(
                    result.completions,
                    offered_qps=serve.qps,
                    slo_us=serve.slo_us,
                    truncated=any(s.truncated for s in lane_schedules),
                    dispatch_overhead_us=result.dispatch_overhead_us,
                    n_lanes=serve.lanes,
                )
            schedule = open_loop_schedule(
                qps=serve.qps, duration_s=serve.duration_s, seed=seed, warmup=warmup
            )
            completions = run_open_loop(
                call, schedule, n_lanes=serve.lanes, concurrency=serve.concurrency
            )
            self._trace_completions(completions)
            return stats_from_completions(
                completions,
                offered_qps=serve.qps,
                slo_us=serve.slo_us,
                truncated=schedule.truncated,
                n_lanes=serve.lanes,
            )
        if serve.client == "threaded":
            result = run_closed_loop_threaded(
                call, concurrency=serve.concurrency, n_lanes=serve.lanes,
                duration_s=serve.duration_s, warmup=warmup,
            )
            self._trace_completions(result.completions)
            return stats_from_completions(
                result.completions,
                slo_us=serve.slo_us,
                dispatch_overhead_us=result.dispatch_overhead_us,
                n_lanes=serve.lanes,
            )
        completions = run_closed_loop(
            call, concurrency=serve.concurrency, n_lanes=serve.lanes,
            duration_s=serve.duration_s, warmup=warmup,
        )
        self._trace_completions(completions)
        return stats_from_completions(completions, slo_us=serve.slo_us, n_lanes=serve.lanes)

    def _bucket_key(
        self,
        spec: BenchmarkSpec,
        bucket_preset: int,
        merged_overrides: dict,
        plan: ExecutionPlan,
        placement: Placement,
        impl: str,
        tuned_params: dict | None,
        width: int,
    ) -> tuple:
        """Cache key of one (shape bucket, batch width) callable. Width 1
        has the ordinary key's shape, so a bucket at the plan's own preset
        and overrides *is* the measure stage's callable; wider calls append
        ``("vmap", width)``."""
        base = (
            spec.name,
            bucket_preset,
            tuple(sorted(merged_overrides.items())),
            False,
            plan.device,
            placement.devices,
            placement.mode,
            impl,
            tuple(sorted((tuned_params or {}).items())),
        )
        return base if width == 1 else base + ("vmap", width)

    def _build_bucket_calls(
        self,
        spec: BenchmarkSpec,
        plan: ExecutionPlan,
        preset: int,
        placement: Placement,
        impl: str,
        tuned_params: dict | None,
    ) -> dict[str, dict[int, Callable[[], Any]]]:
        """One callable per (shape bucket, batch width), through the cache.

        Width 1 is the workload's bound callable (at the plan's own preset
        and overrides, the measure stage's entry: no new build). Width w > 1
        is ``bind_impl(torch.vmap(fn), ...)`` over w *distinct* requests:
        member j's inputs come from ``make_inputs(seed + j)``, stacked on a
        new leading axis and moved to the device once, at the widest width;
        a narrower call takes the first w members (a view). The row's tuned tile
        is reused. A workload whose ``fn`` replays a captured graph
        (``meta["graph_replay"]``) gets its width-w call captured as one
        graph of its own on the card (``core/graphs.py``). Each callable is
        called once here (and synchronized), so no first-call cost lands in
        a served request. A width-w call that fails (an ``fn`` that
        ``torch.vmap`` cannot batch) fails the row, naming the cause.
        """
        from repro_torch.serve.batcher import bucket_widths

        serve = plan.serve
        widths = bucket_widths(serve.dispatch, serve.max_batch)
        calls: dict[str, dict[int, Callable[[], Any]]] = {}
        for bucket in serve.buckets(preset):
            bp = bucket.preset if bucket.preset in spec.presets else min(spec.presets)
            merged = {**plan.overrides_for(spec.name), **dict(bucket.overrides)}
            workload = spec.build_preset(bp, **merged)
            if workload.meta.get("no_jit"):
                raise ValueError(
                    f"mixed-shape serving needs a device workload; "
                    f"{workload.name!r} is no_jit (host-transfer)"
                )
            instances = [workload.make_inputs(plan.seed + j) for j in range(max(widths))]
            stacked = (_stack_members(instances, plan.device) if max(widths) > 1 else None)
            per_width: dict[int, Callable[[], Any]] = {}
            for width in widths:
                key = self._bucket_key(spec, bp, merged, plan, placement, impl, tuned_params,
                                       width)
                if width == 1:
                    wargs = commit_args(instances[0], plan.device)
                    build = functools.partial(self._bind_first_call, workload.fn, workload,
                                              impl, tuned_params, wargs, plan.device)
                else:
                    wargs, in_dims = stacked
                    wargs = tuple(a[:width] if d == 0 else a for a, d in zip(wargs, in_dims))
                    build = functools.partial(self._build_width, workload, impl, tuned_params,
                                              wargs, in_dims, width, plan.device)
                entry = self.cache.lookup(key, build)
                call = self._served(spec.name, width, functools.partial(entry.executable, *wargs))
                call()  # warm: allocations, first dispatch
                _synchronize(plan.device)
                per_width[width] = call
            calls[bucket.label] = per_width
        return calls

    def _bind_first_call(self, fn, workload, impl, tuned_params, args, device) -> _CacheEntry:
        """``fn`` bound to its implementation, called once: the first call
        builds and loads the kernels it reaches (nvcc on first use in the
        process), like the reference's compile."""
        bound = bind_impl(fn, workload, impl, tuned_params)
        bound(*args)
        _synchronize(device)
        return _CacheEntry(executable=bound)

    def _build_width(self, workload, impl, tuned_params, wargs, in_dims, width,
                     device) -> _CacheEntry:
        """The width-``width`` callable of ``workload``, called once."""
        # Members are independent requests: random draws differ between them.
        batched = torch.vmap(workload.fn, in_dims=in_dims, randomness="different")
        bound = bind_impl(batched, workload, impl, tuned_params)
        if device == "cuda" and workload.meta.get("graph_replay"):
            graph = self._graphs

            def executable(*args):
                return graph.run(bound, *args)
        else:
            executable = bound
        try:
            executable(*wargs)
            _synchronize(device)
        except Exception as e:  # noqa: BLE001 — re-raised, naming the cause
            raise ValueError(
                f"{workload.name}: its width-{width} call under torch.vmap failed "
                f"({type(e).__name__}: {e})"
            ) from e
        return _CacheEntry(executable=executable)

    def _mixed_schedule(self, serve: ServeSpec, seed: int, bucket_labels):
        """The mixed-shape request stream: ``serve.trace`` verbatim when the
        file exists (the trace is the load; the qps and mix knobs are
        ignored on replay), else seeded Poisson arrivals with each request's
        bucket drawn from the mix, saved to ``serve.trace`` if one was
        named, so the next run (any dispatch) replays this exact stream."""
        from repro_torch.serve.loadgen import load_trace, open_loop_schedule, sample_mix, save_trace

        warmup = max(serve.concurrency, serve.max_batch, serve.lanes, 2)
        if serve.trace is not None and os.path.exists(serve.trace):
            schedule = load_trace(serve.trace)
            unknown = {r.bucket for r in schedule} - set(bucket_labels)
            if unknown:
                raise ValueError(
                    f"trace {serve.trace!r} names buckets {sorted(map(str, unknown))} "
                    f"absent from this run's mix {sorted(bucket_labels)}"
                )
            return schedule
        schedule = open_loop_schedule(
            qps=serve.qps, duration_s=serve.duration_s, seed=seed, warmup=warmup
        )
        schedule = sample_mix(
            schedule,
            {b.label: b.weight for b in serve.buckets(0)}
            if serve.mix is not None
            else {label: 1.0 for label in bucket_labels},
            seed=seed,
        )
        if serve.trace is not None:
            save_trace(schedule, serve.trace)
        return schedule

    def _serve_mixed(
        self,
        spec: BenchmarkSpec,
        plan: ExecutionPlan,
        preset: int,
        placement: Placement,
        impl: str,
        tuned_params: dict | None,
    ):
        """The continuous-batching serve path: per-(bucket, width)
        callables, a mixed-shape schedule (generated or replayed), and the
        spec's dispatch policy from ``repro_torch.serve.batcher``. The
        stats carry occupancy, padding waste and per-bucket percentiles."""
        from repro_torch.serve.batcher import (
            serve_dynamic,
            serve_fixed_batched,
            serve_mixed_lanes,
            serve_mixed_loop,
        )
        from repro_torch.serve.latency import stats_from_completions

        serve = plan.serve
        calls = self._build_bucket_calls(spec, plan, preset, placement, impl, tuned_params)
        schedule = self._mixed_schedule(serve, plan.seed, set(calls))
        if serve.dispatch == "loop":
            report = serve_mixed_loop(calls, schedule)
        elif serve.dispatch == "lanes":
            report = serve_mixed_lanes(
                calls, schedule, n_lanes=serve.lanes, concurrency=serve.concurrency
            )
        elif serve.dispatch == "batched":
            report = serve_fixed_batched(
                calls, schedule, batch=serve.max_batch, concurrency=serve.concurrency
            )
        else:
            report = serve_dynamic(
                calls, schedule, budget_s=serve.batch_budget_us / 1e6,
                concurrency=serve.concurrency,
            )
        self._trace_completions(report.completions)
        self._trace_batches(report)
        return stats_from_completions(
            report.completions,
            # A replayed trace's offered load is the trace's, not the
            # spec's qps knob (which replay ignores).
            offered_qps=(
                schedule.offered_qps if schedule.offered_qps is not None else serve.qps
            ),
            slo_us=serve.slo_us,
            truncated=schedule.truncated,
            n_lanes=serve.lanes if serve.dispatch == "lanes" else 1,
            batch_occupancy=report.occupancy,
            padding_waste=report.padding_waste,
            n_batches=len(report.batches),
        )

    def _stage_serve(
        self,
        spec: BenchmarkSpec,
        entry: _CacheEntry,
        args: tuple,
        plan: ExecutionPlan,
        preset: int,
        placement: Placement,
        impl: str = "torch",
        tuned_params: dict | None = None,
    ) -> tuple[Any, str | None, float | None, list[BenchmarkRecord]]:
        """Serve the measured callable under the plan's ServeSpec.

        Returns ``(stats, colocate, slowdown, partner_records)``. Without
        co-location this serves the cache entry the measure stage built: no
        new build. With ``colocate`` the partner benchmark is built, placed
        and bound through the same cache (at the plan's implementation, as
        its own row would be), both tenants are served isolated and then
        together (``serve.interference``), and the partner's co-located row
        is returned for the report. A mixed spec goes through
        :meth:`_serve_mixed`. Every callable served is the bound one, which
        enters ``force_impl`` on each call, on whichever thread makes it.
        With ``client_procs`` the row is served by that many client
        processes (``repro_torch.dist``), each building the workload on the
        plan's device through its own engine; a tuning plan's clients
        restore the winner this engine stored in the shared ``cache_dir``
        (without one, each client sweeps for itself, and its trials show in
        the clients' counters).
        """
        serve = plan.serve
        if serve.is_mixed:
            stats = self._serve_mixed(spec, plan, preset, placement, impl, tuned_params)
            return stats, None, None, []
        if serve.client_procs > 0:
            from repro_torch.dist.launcher import run_distributed

            stats = run_distributed(
                benchmark=spec.name,
                preset=preset,
                overrides=dict(plan.overrides_for(spec.name)),
                serve=serve,
                seed=plan.seed,
                device=plan.device,
                impl=impl,
                tune=plan.tune,
                cache_dir=self.cache_dir,
            )
            return stats, None, None, []
        call = self._served(spec.name, 1, functools.partial(entry.executable, *args))
        if serve.colocate is None:
            return self._serve_call(call, serve, plan.seed), None, None, []

        from repro_torch.serve.interference import measure_colocation

        partner_spec = get_benchmark(serve.colocate)
        p_preset = plan.resolve_preset(partner_spec)
        p_workload, p_args = self._stage_build(partner_spec, plan, p_preset)
        p_args = self._stage_place(p_workload, p_args, plan)
        p_impl, _ = self._resolve_impl(p_workload, plan, False)
        p_entry = self._stage_compile(
            partner_spec, p_workload, p_args, plan, p_preset, False, placement, p_impl
        )
        p_call = self._served(partner_spec.name, 1, functools.partial(p_entry.executable, *p_args))

        a_name = spec.name
        b_name = serve.colocate if serve.colocate != spec.name else spec.name + "#2"
        result = measure_colocation(
            {a_name: call, b_name: p_call},
            concurrency=serve.concurrency,
            n_lanes=serve.lanes,
            duration_s=serve.duration_s,
            warmup=max(serve.concurrency, serve.lanes, 2),
            slo_us=serve.slo_us,
        )
        partner = BenchmarkRecord.from_serve(
            partner_spec,
            p_preset,
            result.colocated[b_name],
            mode=serve.mode,
            lanes=serve.lanes,
            client=serve.client,
            name=f"{b_name}@{a_name}",
            colocate=a_name,
            slowdown=result.slowdown(b_name),
            devices=placement.devices,
            placement=placement.mode,
        )
        return result.colocated[a_name], b_name, result.slowdown(a_name), [partner]

    # -- orchestration -----------------------------------------------------

    def run(
        self,
        plan: ExecutionPlan,
        *,
        report_path: str | None = None,
        jsonl_path: str | None = None,
        verbose: bool = False,
    ) -> RunResult:
        specs = plan.select()
        want = max(plan.device_sweep)
        if plan.serve is not None and plan.serve.colocate is not None:
            try:
                get_benchmark(plan.serve.colocate)
            except KeyError as e:
                raise PlanError(str(e)) from None
        if plan.serve is not None and plan.serve.is_mixed and want > 1:
            raise PlanError(
                "mixed-shape serving (mix/trace/batcher dispatch) is "
                f"single-device; the plan sweeps up to {want} devices"
            )
        if plan.serve is not None and want > 1:
            raise PlanError(
                "serving runs on one device in the port (its call counts follow "
                f"the clock, and ranks must make equal calls); the plan sweeps up to {want}"
            )
        _prepare_device(plan)
        metadata = RunMetadata.capture(
            device=plan.device,
            preset=plan.preset,
            devices=plan.devices,
            placement=plan.placement.mode,
            device_sweep=plan.device_sweep,
            timing_window=plan.timing_window,
            impl=plan.impl,
            tune=plan.tune,
            serve=plan.serve,
        )
        rank = sharding.rank()
        # Rank 0 emits; the other ranks run their share of each count.
        emitting = rank == 0
        records: list[BenchmarkRecord] = []
        sweep_stats: list[SweepStat] = []
        # 1-device us_per_call per row name: the scaling baseline. The sweep
        # is ascending, so baselines exist before multi-device rows stream.
        baseline_us: dict[str, float] = {}
        if verbose and emitting:
            print(BenchmarkRecord.csv_header(), flush=True)
        writer = JsonlReportWriter(jsonl_path, metadata) if jsonl_path and emitting else None

        def emit(rec: BenchmarkRecord) -> None:
            if rec.status == "ok":
                if rec.devices == 1:
                    baseline_us[rec.name] = rec.us_per_call
                elif rec.name in baseline_us and rec.us_per_call > 0:
                    rec.scaling_efficiency = baseline_us[rec.name] / rec.us_per_call / rec.devices
            records.append(rec)
            if writer is not None:
                writer.write(rec)
            if verbose:
                print(rec.csv(), flush=True)

        try:
            # The engine's tracer is the ambient one for the run, so the
            # serve layer (lane workers, the threaded client) reaches it.
            with use_tracer(self.tracer):
                for devices in plan.device_sweep:
                    if devices > 1:
                        self._mesh(devices)  # every rank makes the sub-group
                    misses0, hits0 = self.cache.misses, self.cache.hits
                    if rank < devices:
                        for spec in specs:
                            for rec in self._run_benchmark(spec, plan, devices):
                                if emitting:
                                    emit(rec)
                    sweep_stats.append(SweepStat(devices=devices,
                                                 misses=self.cache.misses - misses0,
                                                 hits=self.cache.hits - hits0))
                    if sharding.available_devices() > 1:
                        torch.distributed.barrier()
        finally:
            metadata = self._final_metadata(metadata)
            if writer is not None:
                writer.write_meta(metadata)
                writer.close()
        if report_path and emitting:
            write_report(records, report_path)
        return RunResult(records=records, metadata=metadata, cache=self.cache,
                         sweep_stats=sweep_stats)

    def characterize(
        self,
        spec: BenchmarkSpec,
        plan: ExecutionPlan,
        *,
        backward: bool = False,
        workload: Workload | None = None,
    ) -> CompiledInfo:
        """Compile (through the cache) and characterize, without timing.

        For characterization-only consumers (Table II): shares callables
        with full runs of the same plan parameters, and a cached entry whose
        analysis is memoized returns without making inputs. Pass
        ``workload`` to reuse one already built. Always the kernel's
        default blocks: ``plan.tune`` is a timing concern.
        """
        _prepare_device(plan)
        preset = plan.resolve_preset(spec)
        if workload is None:
            workload = spec.build_preset(preset, **plan.overrides_for(spec.name))
        impl, _ = self._resolve_impl(workload, plan, backward)
        cached = self.cache.peek(
            self._cache_key(spec, plan, preset, backward, plan.placement, impl)
        )
        if cached is not None and cached.info is not None:
            self.cache.hits += 1
            return cached.info
        # Characterize-only flows still time their stages as spans (no-ops
        # under NULL_TRACER), so a traced report run accounts for its time.
        timings: dict[str, float] = {}
        with self._timed_stage("place", timings, bench=spec.name):
            args = workload.make_inputs(plan.seed)
            placement = self._resolve_placement(workload, args, plan.placement)
            args = self._stage_place(workload, args, plan, placement)
        with self._timed_stage("compile", timings, bench=spec.name):
            entry = self._stage_compile(
                spec, workload, args, plan, preset, backward, placement, impl
            )
        with self._timed_stage("characterize", timings, bench=spec.name):
            return self._stage_characterize(workload, entry, args, plan, backward)

    def _final_metadata(self, metadata: RunMetadata) -> RunMetadata:
        """The end of a run stamped into its metadata: the disk cache's
        totals whenever there is a ``cache_dir`` (a report must say whether
        its run was warm), and, when tracing, the counter snapshot with
        those totals folded in under ``cache.``."""
        cache_stats = self.disk_cache.counter_dict() if self.disk_cache is not None else None
        if self.tracer.enabled and cache_stats:
            for k, v in cache_stats.items():
                # set, not inc: the disk cache counts across a long-lived
                # engine's runs; adding again would count twice.
                self.tracer.counters.set(f"cache.{k}", v)
        counters = self.tracer.counters.snapshot() if self.tracer.enabled else None
        if cache_stats is None and counters is None:
            return metadata
        return dataclasses.replace(metadata, cache_stats=cache_stats, counters=counters)

    @contextlib.contextmanager
    def _timed_stage(self, name: str, timings: dict, **attrs: Any):
        """One engine stage = one ``stage_timings_us`` entry and one trace
        span, both from a single perf_counter pair: the record's stage time
        and its span are the same number. Both land even when the stage
        raises, so an error record says where its time went."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            timings[name] = (t1 - t0) * 1e6
            if self.tracer.enabled:
                self.tracer.event(name, t_start=t0, t_end=t1, track="engine", **attrs)

    def _run_benchmark(
        self, spec: BenchmarkSpec, plan: ExecutionPlan, devices: int
    ) -> list[BenchmarkRecord]:
        """The passes of ``spec`` at ``devices`` devices, on each rank of
        them ([] on a rank the effective placement leaves out)."""
        preset = plan.resolve_preset(spec)
        placement = plan.placement_at(devices)
        # Build/place run once per benchmark; their timings are copied into
        # every pass's stage_timings_us (the passes share the work).
        base_timings: dict[str, float] = {}
        stage = "build"
        try:
            with self._timed_stage("build", base_timings, bench=spec.name, devices=devices):
                workload, args = self._stage_build(spec, plan, preset)
            stage = "place"
            placement = self._resolve_placement(workload, args, placement)
            if sharding.rank() >= placement.devices:
                return []  # a one-device row at a wider count: rank 0's alone
            with self._timed_stage("place", base_timings, bench=spec.name, devices=devices):
                args = self._stage_place(workload, args, plan, placement)
        except Exception as e:  # noqa: BLE001 — fault isolation is the contract
            rec = BenchmarkRecord.from_error(
                spec, preset, stage=stage, error=_err_text(e),
                devices=placement.devices, placement=placement.mode,
            )
            rec.stage_timings_us = dict(base_timings)
            return [rec]
        out: list[BenchmarkRecord] = []
        # The ranks of a multi-device row reduce their timings over its mesh.
        self._group = self._mesh(placement.devices).get_group() if placement.devices > 1 else None
        try:
            for backward in plan.passes(workload):
                out.extend(
                    self._run_pass(
                        spec, workload, args, plan, preset, backward, placement,
                        base_timings,
                    )
                )
        finally:
            self._group = None
        return out

    def _run_pass(
        self,
        spec: BenchmarkSpec,
        workload: Workload,
        args: tuple,
        plan: ExecutionPlan,
        preset: int,
        backward: bool,
        placement: Placement,
        base_timings: dict[str, float],
    ) -> list[BenchmarkRecord]:
        stage = "compile"
        impl = "torch"
        timings: dict[str, float] = dict(base_timings)
        span_attrs = dict(bench=workload.name + (".bwd" if backward else ""))
        try:
            impl, impl_fallback = self._resolve_impl(workload, plan, backward)
            span_attrs["impl"] = impl
            tuned_params, tune_trials, tune_trials_us, tune_refused = None, None, None, 0
            if plan.tune:  # an untuned row keeps the stages it always had
                stage = "tune"
                with self._timed_stage("tune", timings, **span_attrs):
                    tuned_params, tune_trials, tune_trials_us, tune_refused = self._stage_tune(
                        spec, workload, args, plan, preset, backward, placement, impl
                    )
                stage = "compile"
            with self._timed_stage("compile", timings, **span_attrs):
                entry = self._stage_compile(
                    spec, workload, args, plan, preset, backward, placement, impl,
                    tuned_params,
                )
            stage = "measure"
            with self._timed_stage("measure", timings, **span_attrs):
                timing = self._stage_measure(workload, entry, args, plan, backward)
            stage = "characterize"
            with self._timed_stage("characterize", timings, **span_attrs):
                info = self._stage_characterize(workload, entry, args, plan, backward)
            rec = BenchmarkRecord.from_measurement(
                spec, preset, timing, info,
                devices=placement.devices, placement=placement.mode,
                impl=impl,
                # A kernel row on the CPU ran the kernels' plain versions: a
                # check of the path, never a kernel number. None on torch rows.
                impl_interpret=(plan.device == "cpu") if impl == "kernel" else None,
                impl_fallback=impl_fallback,
                tuned_params=tuned_params,
                tune_trials=tune_trials,
                tune_trials_us=tune_trials_us,
            )
            if tune_refused:
                rec.derived += f";tune_refused={tune_refused}"
            rec.stage_timings_us = timings
            extra: list[BenchmarkRecord] = []
            # Serving measures request-level concurrency of the forward
            # pass; backward rows keep their isolation-mode meaning.
            if plan.serve is not None and not backward:
                stage = "serve"
                with self._timed_stage("serve", timings, **span_attrs):
                    stats, colocate, slowdown, extra = self._stage_serve(
                        spec, entry, args, plan, preset, placement, impl, tuned_params,
                    )
                rec.apply_serve(
                    stats,
                    mode=plan.serve.mode,
                    lanes=plan.serve.lanes,
                    client=plan.serve.client,
                    colocate=colocate,
                    slowdown=slowdown,
                    dispatch=plan.serve.dispatch,
                    mix=_mix_label(plan.serve),
                )
            return [rec] + extra
        except Exception as e:  # noqa: BLE001 — fault isolation is the contract
            err = BenchmarkRecord.from_error(
                spec, preset, stage=stage, error=_err_text(e), backward=backward,
                devices=placement.devices, placement=placement.mode, impl=impl,
            )
            err.stage_timings_us = timings
            return [err]


def _prepare_device(plan: ExecutionPlan) -> None:
    """Refuse what this world cannot run (more devices than ranks, a
    missing card, more ranks than cards), and make f32 rows true f32: no
    TF32 in matmuls or cuDNN convolutions."""
    want = max(plan.device_sweep)
    available = sharding.available_devices()
    if want > available:
        raise PlanError(f"plan requests {want} devices but only {available} available")
    if plan.device == "cuda" and not torch.cuda.is_available():
        raise PlanError(
            "plan runs on cuda but torch.cuda.is_available() is False; "
            "ask for device='cpu' to run on the CPU"
        )
    if plan.device == "cuda" and available > torch.cuda.device_count():
        raise PlanError(f"a world of {available} ranks needs {available} cards (NCCL "
                        f"refuses two ranks on one); {torch.cuda.device_count()} available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _whole(tree):
    """A call's outputs or arguments with each DTensor gathered to the whole
    tensor (a collective: every rank of its mesh calls it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_whole(t) for t in tree)
    return tree


def _synchronize(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _device_name(device: str) -> str | None:
    return torch.cuda.get_device_name(0) if device == "cuda" else None


def _stack_members(instances: list[tuple], device: str) -> tuple[tuple, tuple]:
    """Member inputs stacked on a new leading axis and moved to ``device``
    once -> (args, in_dims). A non-tensor argument (Dropout's and
    ParticleFilter's seed) cannot be batched: member 0's passes to every
    member unbatched, and their random draws still differ between members
    (``torch.vmap(..., randomness="different")``)."""
    args, in_dims = [], []
    for leaves in zip(*instances):
        if all(isinstance(x, torch.Tensor) for x in leaves):
            args.append(torch.stack(leaves))
            in_dims.append(0)
        else:
            args.append(leaves[0])
            in_dims.append(None)
    return commit_args(args, device), tuple(in_dims)


def _mix_label(serve: ServeSpec) -> str | None:
    """The record's compact mix: ``label@weight`` per bucket (None outside
    a mix)."""
    if not serve.is_mixed or serve.mix is None:
        return None
    return ",".join(f"{b.label}@{b.weight:g}" for b in serve.mix)


def _err_text(e: BaseException, limit: int = 500) -> str:
    # Collapse whitespace: error records land in one-line CSV/JSONL rows.
    text = " ".join(f"{type(e).__name__}: {e}".split())
    return text if len(text) <= limit else text[: limit - 3] + "..."
