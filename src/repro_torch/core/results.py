"""Result records and reports for the suite runner.

Counterpart of ``repro/core/results.py``, with the same record schema and
``SCHEMA_VERSION``, so the reference's ``load_records`` / ``load_run`` read
the port's reports unchanged and rows compare by name. Two formats share
the schema:

- **JSON** (``write_report``): one array of record objects, written
  atomically at the end of a run.
- **JSONL** (``JsonlReportWriter``): streaming — a ``meta`` line carrying
  run provenance, then one ``record`` line per benchmark, flushed as each
  finishes, so a killed run still leaves every completed row on disk.

Error rows (per-benchmark fault isolation in the engine) are ordinary
records with ``status="error"``. A missing, empty or unparseable report
raises :class:`ReportError`.

The port's :class:`RunMetadata` records what the reference's cannot: the
torch and CUDA versions, the card's name and power limit (as ``nvidia-smi``
reports it), and both TF32 switches. It keeps a ``jax_version`` key (None)
because the reference's ``RunMetadata`` requires one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import IO, Iterable, Sequence

import torch

from repro_torch.core.harness import CompiledInfo, TimingResult
from repro_torch.core.metrics import utilization_scale10
from repro_torch.core.plan import ServeSpec

__all__ = [
    "SCHEMA_VERSION",
    "BenchmarkRecord",
    "RunMetadata",
    "JsonlReportWriter",
    "ReportError",
    "to_csv_lines",
    "write_report",
    "load_run",
    "load_records",
    "gpu_name_and_power_limit",
]

# The reference's schema version; the record fields below are its fields.
SCHEMA_VERSION = 9


class ReportError(ValueError):
    """A report that cannot be read as asked (missing file, empty file,
    no usable records). CLIs print the one-line message and exit nonzero
    instead of dumping a traceback."""


@dataclasses.dataclass
class BenchmarkRecord:
    """One row of suite output: timing + analytic characterization.

    ``status`` is ``"ok"`` for measured rows and ``"error"`` for rows the
    engine emitted after a per-benchmark failure (``error`` holds the
    exception text, ``derived`` the stage; the numeric fields are zeroed).
    ``us_per_call`` is the sync-mode time (an event pair and a
    synchronization per call); ``us_per_call_windowed`` the time per call
    with ``timing_window`` calls per event pair; ``timer_dispatch_us`` their
    difference. ``impl`` is the implementation the row actually timed
    (``torch`` or ``kernel``); ``impl_interpret=True`` marks a kernel row
    that ran the kernels' plain versions on the CPU, never a kernel number;
    ``impl_fallback`` says why a kernel plan timed torch for this row.
    ``tuned_params`` / ``tune_trials`` / ``tune_trials_us`` report the tune
    stage: the winning tile, how many candidates were timed (0 = the winner
    was restored from the disk cache, or the kernel has one candidate), and
    the sweep's wall time; a candidate the kernel refused adds
    ``tune_refused=N`` to ``derived``.

    The serving columns (``serve_*``, ``latency_*``, ``*_qps``,
    ``dispatch_overhead_us``, ``lane_qps``, and for the mixed-shape paths
    ``batch_occupancy``, ``padding_waste``, ``serve_batches`` and
    ``bucket_latency_us``) are filled when the plan carried a
    :class:`~repro_torch.core.plan.ServeSpec`, as the reference fills them
    (:meth:`apply_serve`). The placement and distributed columns are the
    reference's, kept so both packages' reports share one schema.
    """

    name: str
    level: int
    dwarf: str | None
    domain: str | None
    preset: int
    us_per_call: float
    achieved_gflops: float
    achieved_gbps: float
    compute_util10: int  # paper-style 0..10 bar (roofline fraction of compute)
    memory_util10: int
    dominant: str
    derived: str = ""
    status: str = "ok"
    error: str = ""
    devices: int = 1
    placement: str = "replicate"
    scaling_efficiency: float | None = None
    # Windowed timing columns — None when only sync mode ran.
    us_per_call_windowed: float | None = None
    timing_window: int | None = None
    timer_dispatch_us: float | None = None  # sync − windowed, clamped at 0
    # Implementation axis.
    impl: str = "torch"
    impl_interpret: bool | None = None  # kernel row that ran plain versions
    impl_fallback: str | None = None  # why a kernel plan timed torch
    tuned_params: dict | None = None
    tune_trials: int | None = None
    tune_trials_us: float | None = None
    # Serving columns — None unless the row was served.
    serve_mode: str | None = None
    serve_lanes: int | None = None
    serve_requests: int | None = None
    latency_p50_us: float | None = None
    latency_p95_us: float | None = None
    latency_p99_us: float | None = None
    latency_max_us: float | None = None
    achieved_qps: float | None = None
    offered_qps: float | None = None
    goodput_qps: float | None = None
    serve_colocate: str | None = None
    slowdown_vs_isolated: float | None = None
    serve_client: str | None = None
    serve_truncated: bool | None = None
    serve_slo_us: float | None = None
    dispatch_overhead_us: float | None = None
    lane_qps: list[float] | None = None
    serve_dispatch: str | None = None
    serve_mix: str | None = None
    batch_occupancy: float | None = None
    padding_waste: float | None = None
    serve_batches: int | None = None
    bucket_latency_us: dict | None = None
    client_procs: int | None = None
    proc_qps: list[float] | None = None
    # Stage name -> wall microseconds this row spent in that stage (build
    # and place timings are copied into every pass's row).
    stage_timings_us: dict | None = None

    def apply_serve(
        self,
        stats,
        *,
        mode: str,
        lanes: int,
        client: str = "single",
        colocate: str | None = None,
        slowdown: float | None = None,
        dispatch: str | None = None,
        mix: str | None = None,
    ) -> "BenchmarkRecord":
        """Fold a ``serve.latency.LatencyStats`` into this record."""
        self.serve_mode = mode
        self.serve_lanes = lanes
        self.serve_requests = stats.requests
        self.latency_p50_us = stats.p50_us
        self.latency_p95_us = stats.p95_us
        self.latency_p99_us = stats.p99_us
        self.latency_max_us = stats.max_us
        self.achieved_qps = stats.achieved_qps
        self.offered_qps = stats.offered_qps
        self.goodput_qps = stats.goodput_qps
        self.serve_colocate = colocate
        self.slowdown_vs_isolated = slowdown
        self.serve_client = client
        self.serve_truncated = stats.truncated
        self.serve_slo_us = stats.slo_us
        self.dispatch_overhead_us = stats.dispatch_overhead_us
        self.lane_qps = list(stats.lane_qps) if stats.lane_qps is not None else None
        # Only a distributed run's stats (dist.launcher.DistLatencyStats)
        # carry the process accounting.
        self.client_procs = getattr(stats, "client_procs", None) or None
        proc_qps = getattr(stats, "proc_qps", None)
        self.proc_qps = list(proc_qps) if proc_qps is not None else None
        # The batching columns are None outside the mixed-shape paths.
        self.serve_dispatch = dispatch
        self.serve_mix = mix
        self.batch_occupancy = stats.batch_occupancy
        self.padding_waste = stats.padding_waste
        self.serve_batches = stats.n_batches
        self.bucket_latency_us = (
            {
                label: {
                    "requests": b.requests,
                    "p50_us": b.p50_us,
                    "p95_us": b.p95_us,
                    "p99_us": b.p99_us,
                }
                for label, b in stats.bucket_stats
            }
            if stats.bucket_stats
            else None
        )
        return self

    @classmethod
    def from_serve(
        cls,
        spec,
        preset: int,
        stats,
        *,
        mode: str,
        lanes: int,
        client: str = "single",
        name: str | None = None,
        colocate: str | None = None,
        slowdown: float | None = None,
        devices: int = 1,
        placement: str = "replicate",
    ) -> "BenchmarkRecord":
        """A serve-only row (the co-location partner, served but not
        measured on its own): ``us_per_call`` is its p50 serving latency."""
        rec = cls(
            name=name if name is not None else spec.name,
            level=spec.level,
            dwarf=spec.dwarf,
            domain=spec.domain,
            preset=preset,
            us_per_call=stats.p50_us,
            achieved_gflops=0.0,
            achieved_gbps=0.0,
            compute_util10=0,
            memory_util10=0,
            dominant="serve",
            derived=f"colocated_with={colocate}" if colocate else "serve",
            devices=devices,
            placement=placement,
        )
        return rec.apply_serve(
            stats, mode=mode, lanes=lanes, client=client,
            colocate=colocate, slowdown=slowdown,
        )

    @classmethod
    def from_measurement(
        cls,
        spec,
        preset: int,
        timing: TimingResult,
        compiled: CompiledInfo,
        *,
        devices: int = 1,
        placement: str = "replicate",
        impl: str = "torch",
        impl_interpret: bool | None = None,
        impl_fallback: str | None = None,
        tuned_params: dict | None = None,
        tune_trials: int | None = None,
        tune_trials_us: float | None = None,
    ) -> "BenchmarkRecord":
        r = compiled.roofline
        bound = r.bound_s if r.bound_s > 0 else 1.0
        return cls(
            name=timing.name,
            level=spec.level,
            dwarf=spec.dwarf,
            domain=spec.domain,
            preset=preset,
            us_per_call=timing.us_per_call,
            achieved_gflops=timing.achieved_gflops,
            achieved_gbps=timing.achieved_gbps,
            compute_util10=utilization_scale10(r.compute_s / bound),
            memory_util10=utilization_scale10(r.memory_s / bound),
            dominant=r.dominant,
            derived=(
                f"flops={r.flops:.3e};bytes={r.hbm_bytes:.3e};"
                f"coll={r.collective_bytes:.3e}"
            ),
            devices=devices,
            placement=placement,
            us_per_call_windowed=timing.us_per_call_windowed,
            timing_window=timing.timing_window,
            timer_dispatch_us=timing.timer_dispatch_us,
            impl=impl,
            impl_interpret=impl_interpret,
            impl_fallback=impl_fallback,
            tuned_params=tuned_params,
            tune_trials=tune_trials,
            tune_trials_us=tune_trials_us,
        )

    @classmethod
    def from_error(
        cls,
        spec,
        preset: int,
        *,
        stage: str,
        error: str,
        backward: bool = False,
        devices: int = 1,
        placement: str = "replicate",
        impl: str = "torch",
    ) -> "BenchmarkRecord":
        return cls(
            name=spec.name + (".bwd" if backward else ""),
            level=spec.level,
            dwarf=spec.dwarf,
            domain=spec.domain,
            preset=preset,
            us_per_call=0.0,
            achieved_gflops=0.0,
            achieved_gbps=0.0,
            compute_util10=0,
            memory_util10=0,
            dominant="error",
            derived=f"stage={stage}",
            status="error",
            error=error,
            devices=devices,
            placement=placement,
            impl=impl,
        )

    @classmethod
    def csv_header(cls) -> str:
        return "name,us_per_call,devices,placement,derived"

    def csv(self) -> str:
        if self.status != "ok":
            return (
                f"{self.name},0.00,{self.devices},{self.placement},"
                f"{self.status}:{self.derived}"
            )
        extra = ""
        if self.scaling_efficiency is not None:
            extra += f";eff={self.scaling_efficiency:.3f}"
        if self.us_per_call_windowed is not None:
            extra += (
                f";win_us={self.us_per_call_windowed:.2f}"
                f";timer_dispatch_us={self.timer_dispatch_us:.2f}"
            )
        if self.impl != "torch" or self.impl_fallback is not None:
            extra += f";impl={self.impl}"
            if self.impl_interpret:
                extra += ";interpret=1"
            if self.impl_fallback is not None:
                extra += f";impl_fallback={self.impl_fallback}"
        if self.tuned_params is not None:
            tuned = "/".join(f"{k}={v}" for k, v in sorted(self.tuned_params.items()))
            extra += (
                f";tuned={tuned or 'default'};tune_trials={self.tune_trials};"
                f"tune_us={self.tune_trials_us:.0f}"
            )
        return (
            f"{self.name},{self.us_per_call:.2f},{self.devices},"
            f"{self.placement},{self.derived}{extra}{self._serve_csv()}"
        )

    def _serve_csv(self) -> str:
        """The serve part of the derived text, as the reference writes it."""
        if self.serve_mode is None:
            return ""
        serve = (
            f";serve={self.serve_mode};client={self.serve_client or 'single'};"
            f"lanes={self.serve_lanes};"
            f"p50_us={self.latency_p50_us:.1f};"
            f"p99_us={self.latency_p99_us:.1f};qps={self.achieved_qps:.1f}"
        )
        if self.serve_truncated:
            serve += ";truncated=1"
        if self.serve_slo_us is not None:
            serve += f";slo_us={self.serve_slo_us:.0f};goodput_qps={self.goodput_qps:.1f}"
        if self.dispatch_overhead_us is not None:
            serve += f";dispatch_us={self.dispatch_overhead_us:.1f}"
        if self.client_procs:
            serve += f";client_procs={self.client_procs}"
        if self.serve_dispatch is not None and self.serve_dispatch != "lanes":
            serve += f";dispatch={self.serve_dispatch}"
        if self.batch_occupancy is not None:
            serve += (
                f";occupancy={self.batch_occupancy:.3f};"
                f"padding_waste={self.padding_waste:.3f}"
            )
        if self.bucket_latency_us:
            buckets = "/".join(
                f"{label}:p50={b['p50_us']:.0f}"
                for label, b in sorted(self.bucket_latency_us.items())
            )
            serve += f";buckets={buckets}"
        if self.slowdown_vs_isolated is not None:
            serve += (
                f";colocate={self.serve_colocate};"
                f"slowdown={self.slowdown_vs_isolated:.2f}"
            )
        return serve


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` as it prints them (one
    line per card), or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


@dataclasses.dataclass(frozen=True)
class RunMetadata:
    """Provenance header for a run: enough to interpret the rows later."""

    backend: str  # "cuda" or "cpu": where the rows ran
    device_count: int
    jax_version: str | None = None  # the reference's key; the port has no JAX
    schema_version: int = SCHEMA_VERSION
    preset: int | None = None
    devices: int = 1
    placement: str = "replicate"
    device_sweep: tuple[int, ...] = (1,)
    timing_window: int = 1
    impl: str = "torch"
    tune: bool = False  # whether the tune stage was enabled
    serve: ServeSpec | None = None  # the plan's ServeSpec, None for isolation runs
    torch_version: str | None = None
    cuda_version: str | None = None  # the CUDA torch was built with
    device_name: str | None = None  # torch.cuda.get_device_name(), or "cpu"
    gpu_power_limit: str | None = None  # nvidia-smi name,power.limit
    allow_tf32_matmul: bool | None = None
    allow_tf32_cudnn: bool | None = None
    # The disk cache's counters (core/hlocache.py), stamped at the end of a
    # run that had a --cache-dir; None otherwise.
    cache_stats: dict | None = None
    # The tracer's counter snapshot (repro_torch.obs), with the disk
    # cache's totals under a ``cache.`` prefix, stamped at the end of a
    # traced run; None when tracing was off.
    counters: dict | None = None

    def __post_init__(self) -> None:
        # JSON round-trips tuples as lists, the ServeSpec as a dict (its mix
        # as dicts too).
        if not isinstance(self.device_sweep, tuple):
            object.__setattr__(self, "device_sweep", tuple(self.device_sweep))
        if isinstance(self.serve, dict):
            fields = {f.name for f in dataclasses.fields(ServeSpec)}
            object.__setattr__(
                self, "serve", ServeSpec(**{k: v for k, v in self.serve.items() if k in fields})
            )

    @classmethod
    def capture(
        cls,
        *,
        device: str,
        preset: int | None = None,
        devices: int = 1,
        placement: str = "replicate",
        device_sweep: tuple[int, ...] | None = None,
        timing_window: int = 1,
        impl: str = "torch",
        tune: bool = False,
        serve: ServeSpec | None = None,
    ) -> "RunMetadata":
        cuda = device == "cuda"
        return cls(
            backend=device,
            device_count=torch.cuda.device_count() if cuda else 1,
            preset=preset,
            devices=devices,
            placement=placement,
            device_sweep=device_sweep if device_sweep is not None else (devices,),
            timing_window=timing_window,
            impl=impl,
            tune=tune,
            serve=serve,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            device_name=torch.cuda.get_device_name(0) if cuda else "cpu",
            gpu_power_limit=gpu_name_and_power_limit() if cuda else None,
            allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
            allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
        )


def to_csv_lines(records: Iterable[BenchmarkRecord]) -> list[str]:
    return [BenchmarkRecord.csv_header()] + [r.csv() for r in records]


def write_report(records: Sequence[BenchmarkRecord], path: str) -> None:
    """JSON report, one object per record."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump([dataclasses.asdict(r) for r in records], f, indent=1, sort_keys=True)
    os.replace(tmp, path)


class JsonlReportWriter:
    """Streaming JSONL report: a ``meta`` line, then one line per record.

    Each line is flushed as written so partial runs leave usable reports.
    """

    def __init__(self, path: str, metadata: RunMetadata | None = None) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f: IO[str] = open(path, "w")
        if metadata is not None:
            self._emit({"kind": "meta", **dataclasses.asdict(metadata)})

    def _emit(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, sort_keys=True) + "\n")
        self._f.flush()

    def write(self, record: BenchmarkRecord) -> None:
        self._emit({"kind": "record", **dataclasses.asdict(record)})

    def write_meta(self, metadata: RunMetadata) -> None:
        """Emit another meta line. ``load_run`` keeps the last one, so the
        engine writes the end-of-run metadata (with its cache counters) just
        before closing, and a killed run still has the header."""
        self._emit({"kind": "meta", **dataclasses.asdict(metadata)})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _record_from_dict(d: dict) -> BenchmarkRecord:
    fields = {f.name for f in dataclasses.fields(BenchmarkRecord)}
    return BenchmarkRecord(**{k: v for k, v in d.items() if k in fields})


def load_run(path: str) -> tuple[RunMetadata | None, list[BenchmarkRecord]]:
    """Read either report format; metadata is None for JSON arrays.

    Raises :class:`ReportError` when the report is missing or holds no
    records at all. A torn final line (a run killed mid-write) is dropped.
    """
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise ReportError(f"cannot read report {path}: {e.strerror or e}") from None
    if text.lstrip().startswith("["):
        try:
            return None, [_record_from_dict(d) for d in json.loads(text)]
        except (json.JSONDecodeError, TypeError) as e:
            raise ReportError(f"report {path} is not valid JSON: {e}") from None
    meta: RunMetadata | None = None
    records: list[BenchmarkRecord] = []
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ReportError(f"report {path} is empty (no metadata, no records)")
    for i, line in enumerate(lines):
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise
        kind = obj.pop("kind", "record")
        if kind == "meta":
            fields = {f.name for f in dataclasses.fields(RunMetadata)}
            meta = RunMetadata(**{k: v for k, v in obj.items() if k in fields})
        else:
            records.append(_record_from_dict(obj))
    return meta, records


def load_records(path: str) -> list[BenchmarkRecord]:
    return load_run(path)[1]
