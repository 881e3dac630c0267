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
Serving and device sweeps are not ported yet, and the disk cache holds the
tune winners alone.

Rows that replay a captured CUDA graph (``core/graphs.py``) key it by
addresses and route, not by tile: every such row's kernel has a one-entry
tune space today, so no swept row is captured. One that is must put the
candidate into its graph's key.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.core.hlocache import HloDiskCache
from repro_torch.core.plan import ExecutionPlan, Placement, PlanError
from repro_torch.core.registry import BenchmarkSpec, Workload
from repro_torch.core.results import (
    BenchmarkRecord,
    JsonlReportWriter,
    RunMetadata,
    write_report,
)
from repro_torch.kernels import ops as kernel_ops

__all__ = ["CompileCache", "Engine", "RunResult", "bind_impl"]

# (name, preset, frozen-overrides, backward, device, devices, placement,
#  impl, frozen-tuned-params — () when the pass was not tuned)
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

        def build() -> _CacheEntry:
            bound = bind_impl(fn, workload, impl, tuned_params)
            # The first call builds and loads the kernels it reaches (nvcc
            # on first use in the process), like the reference's compile.
            bound(*args)
            _synchronize(plan.device)
            return _CacheEntry(executable=bound)

        return self.cache.lookup(key, build)

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
        _prepare_device(plan)
        metadata = RunMetadata.capture(
            device=plan.device,
            preset=plan.preset,
            devices=plan.devices,
            placement=plan.placement.mode,
            timing_window=plan.timing_window,
            impl=plan.impl,
            tune=plan.tune,
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
            out.append(
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
    ) -> BenchmarkRecord:
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
            return rec
        except Exception as e:  # noqa: BLE001 — fault isolation is the contract
            err = BenchmarkRecord.from_error(
                spec, preset, stage=stage, error=_err_text(e), backward=backward,
                devices=placement.devices, placement=placement.mode, impl=impl,
            )
            err.stage_timings_us = timings
            return err


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


def _err_text(e: BaseException, limit: int = 500) -> str:
    # Collapse whitespace: error records land in one-line CSV/JSONL rows.
    text = " ".join(f"{type(e).__name__}: {e}".split())
    return text if len(text) <= limit else text[: limit - 3] + "..."
