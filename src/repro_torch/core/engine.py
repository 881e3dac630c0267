"""Staged execution engine: build → place → [tune] → compile → measure →
characterize → report.

Counterpart of ``repro/core/engine.py``, main path only. For every selected
benchmark the engine runs the stages:

- **build**: instantiate the workload from the spec at the plan's preset
  (plus Rodinia-style overrides) and make its inputs from the plan's seed.
- **place**: one device, ``replicate`` (the only placement ported so far;
  ``run`` refuses others with :class:`PlanError`): ``harness.commit_args``
  moves every input to the plan's device once, before any timed call.
  Host-transfer workloads (``meta["no_jit"]``, the bus-speed rows) time
  the transfer itself, so their inputs stay where ``make_inputs`` put them,
  except the positions ``meta["device_args"]`` names (a destination buffer,
  a tensor to read back).
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

Failures are isolated per benchmark: an exception in any stage yields a
``status="error"`` record naming the stage, and the suite keeps going.
Device sweeps, distributed load generation and the serve stage's trace
events are not ported yet, and the disk cache holds the tune winners
alone.

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

__all__ = ["CompileCache", "Engine", "RunResult", "bind_impl"]

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


@dataclasses.dataclass
class RunResult:
    records: list[BenchmarkRecord]
    metadata: RunMetadata
    cache: CompileCache

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
    processes."""

    def __init__(
        self, cache: CompileCache | None = None, cache_dir: str | None = None
    ) -> None:
        self.cache = cache if cache is not None else CompileCache()
        self.disk_cache = HloDiskCache(cache_dir) if cache_dir else None
        # Width-w serve calls of graph-replay workloads, captured whole.
        self._graphs = GraphCache(capacity=64)

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

    def _stage_place(self, workload: Workload, args: tuple, plan: ExecutionPlan) -> tuple:
        """Move the inputs to the plan's device once (one device,
        replicate), so no timed call pays a host copy. A no_jit workload's
        inputs stay on the host, but for the positions its
        ``meta["device_args"]`` names."""
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
        answer), so a warm run restores it at zero trials.
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
        trials_us = 0.0  # the sum of the timed candidates' wall spans
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
            trials_us += (time.perf_counter() - c0) * 1e6
            trials += 1
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
            workload.validate(out, args)
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
        """
        serve = plan.serve
        if serve.is_mixed:
            stats = self._serve_mixed(spec, plan, preset, placement, impl, tuned_params)
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
        if plan.serve is not None and plan.serve.colocate is not None:
            try:
                get_benchmark(plan.serve.colocate)
            except KeyError as e:
                raise PlanError(str(e)) from None
        if plan.serve is not None and plan.serve.is_mixed and plan.devices > 1:
            raise PlanError(
                "mixed-shape serving (mix/trace/batcher dispatch) is "
                f"single-device; the plan asks for {plan.devices} devices"
            )
        _prepare_device(plan)
        metadata = RunMetadata.capture(
            device=plan.device,
            preset=plan.preset,
            devices=plan.devices,
            placement=plan.placement.mode,
            timing_window=plan.timing_window,
            impl=plan.impl,
            tune=plan.tune,
            serve=plan.serve,
        )
        records: list[BenchmarkRecord] = []
        if verbose:
            print(BenchmarkRecord.csv_header(), flush=True)
        writer = JsonlReportWriter(jsonl_path, metadata) if jsonl_path else None
        try:
            for spec in specs:
                for rec in self._run_benchmark(spec, plan):
                    records.append(rec)
                    if writer is not None:
                        writer.write(rec)
                    if verbose:
                        print(rec.csv(), flush=True)
        finally:
            if self.disk_cache is not None:
                # A report must say whether its run was warm.
                metadata = dataclasses.replace(
                    metadata, cache_stats=self.disk_cache.counter_dict()
                )
            if writer is not None:
                writer.write_meta(metadata)
                writer.close()
        if report_path:
            write_report(records, report_path)
        return RunResult(records=records, metadata=metadata, cache=self.cache)

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
        args = self._stage_place(workload, workload.make_inputs(plan.seed), plan)
        entry = self._stage_compile(
            spec, workload, args, plan, preset, backward, plan.placement, impl
        )
        return self._stage_characterize(workload, entry, args, plan, backward)

    @contextlib.contextmanager
    def _timed_stage(self, name: str, timings: dict):
        """One engine stage = one ``stage_timings_us`` entry from a
        perf_counter pair; the entry lands even when the stage raises."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            timings[name] = (time.perf_counter() - t0) * 1e6

    def _run_benchmark(
        self, spec: BenchmarkSpec, plan: ExecutionPlan
    ) -> list[BenchmarkRecord]:
        preset = plan.resolve_preset(spec)
        placement = plan.placement
        # Build/place run once per benchmark; their timings are copied into
        # every pass's stage_timings_us (the passes share the work).
        base_timings: dict[str, float] = {}
        stage = "build"
        try:
            with self._timed_stage("build", base_timings):
                workload, args = self._stage_build(spec, plan, preset)
            stage = "place"
            with self._timed_stage("place", base_timings):
                args = self._stage_place(workload, args, plan)
        except Exception as e:  # noqa: BLE001 — fault isolation is the contract
            rec = BenchmarkRecord.from_error(
                spec, preset, stage=stage, error=_err_text(e),
                devices=placement.devices, placement=placement.mode,
            )
            rec.stage_timings_us = dict(base_timings)
            return [rec]
        out: list[BenchmarkRecord] = []
        for backward in plan.passes(workload):
            out.extend(
                self._run_pass(
                    spec, workload, args, plan, preset, backward, placement,
                    base_timings,
                )
            )
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
        try:
            impl, impl_fallback = self._resolve_impl(workload, plan, backward)
            tuned_params, tune_trials, tune_trials_us, tune_refused = None, None, None, 0
            if plan.tune:  # an untuned row keeps the stages it always had
                stage = "tune"
                with self._timed_stage("tune", timings):
                    tuned_params, tune_trials, tune_trials_us, tune_refused = self._stage_tune(
                        spec, workload, args, plan, preset, backward, placement, impl
                    )
                stage = "compile"
            with self._timed_stage("compile", timings):
                entry = self._stage_compile(
                    spec, workload, args, plan, preset, backward, placement, impl,
                    tuned_params,
                )
            stage = "measure"
            with self._timed_stage("measure", timings):
                timing = self._stage_measure(workload, entry, args, plan, backward)
            stage = "characterize"
            with self._timed_stage("characterize", timings):
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
                with self._timed_stage("serve", timings):
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
    """Refuse what the port cannot run (more than one device, a missing
    card), and make f32 rows true f32: no TF32 in matmuls or cuDNN
    convolutions."""
    if plan.devices != 1 or plan.placement.mode != "replicate":
        raise PlanError(
            f"plan requests {plan.devices} devices with placement "
            f"{plan.placement.mode!r}; the port runs on one device, replicate"
        )
    if plan.device == "cuda" and not torch.cuda.is_available():
        raise PlanError(
            "plan runs on cuda but torch.cuda.is_available() is False; "
            "ask for device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
