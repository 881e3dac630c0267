"""Thread-per-lane serving client — host-side issue concurrency.

Counterpart of ``repro/serve/client.py``. The single-threaded client
(``serve.lanes.run_open_loop`` / ``run_closed_loop``) dispatches every lane
from one host thread, so requests enter the card one ``call()`` at a time
and host-side contention between lanes is invisible by construction. Here
each :class:`~repro_torch.serve.lanes.DispatchLane` gets its *own issuing
thread*:

- **open loop** (:func:`run_open_loop_threaded`): each thread walks its
  lane's deterministic sub-schedule (``loadgen.open_loop_lane_schedules``
  — seeded child RNG streams whose merge is Poisson at the target QPS),
  sleeping until each scheduled arrival and recording latency from it, so
  queueing delay counts exactly as in the single-threaded convention.
- **closed loop** (:func:`run_closed_loop_threaded`): each thread keeps
  its own lane's window full until the shared deadline.

Every thread enqueues on the device's current stream, as the reference's
threads all feed one JAX runtime: no stream a lane. (PyTorch's current
stream is per thread, and a new thread starts on the device's default
stream.) A lane reads completion through the CUDA event it recorded on
that stream after the call (``serve/lanes.py``). ``force_impl`` is a
context variable, which a new thread does not inherit: the served callable
must be the engine's bound one, which enters it on every call.

Completions funnel through a lock-guarded :class:`CompletionSink`; per
lane, the client accounts *dispatch overhead* — the host time spent inside
``call()`` enqueueing work, which PyTorch returns from before the card
finishes — so host contention between issuing threads shows up as a
measured number (:class:`LaneReport`), not a silent skew. A worker that
raises stops its lane only; the first error is re-raised after the join so
the engine's fault isolation sees it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

# The client axis is declared next to ServeSpec's validation (one source
# of truth for "which clients exist"); re-exported here for serve users.
from repro_torch.core.plan import SERVE_CLIENTS
from repro_torch.obs import current_tracer
from repro_torch.serve.lanes import Completion, DispatchLane, lane_depth
from repro_torch.serve.latency import lane_qps_from_completions
from repro_torch.serve.loadgen import Request, Schedule

__all__ = [
    "SERVE_CLIENTS",
    "CompletionSink",
    "LaneReport",
    "ClientResult",
    "run_open_loop_threaded",
    "run_closed_loop_threaded",
]


class CompletionSink:
    """Thread-safe completion collector shared by all lane workers.

    Workers buffer completions in a thread-local list and flush it here
    once, when their lane is drained — the lock sits outside the issue
    hot loop, so the sink never adds cross-lane synchronization to the
    per-request host costs the client exists to measure."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: list[Completion] = []

    def add(self, completions: Sequence[Completion]) -> None:
        if completions:
            with self._lock:
                self._items.extend(completions)

    def harvest(self) -> list[Completion]:
        """Everything collected so far (call after joining the workers)."""
        with self._lock:
            return list(self._items)


@dataclasses.dataclass(frozen=True)
class LaneReport:
    """Per-lane client-side accounting for one threaded serve."""

    lane: int
    requests: int  # requests this lane's thread issued
    dispatch_overhead_us: float  # mean host time inside call() per request
    achieved_qps: float  # non-warmup completions per active second


@dataclasses.dataclass(frozen=True)
class ClientResult:
    """What a threaded client run produced: the merged completion list
    plus per-lane issue accounting."""

    completions: tuple[Completion, ...]
    lane_reports: tuple[LaneReport, ...]

    @property
    def dispatch_overhead_us(self) -> float:
        """Mean host dispatch time per request across all lanes."""
        n = sum(r.requests for r in self.lane_reports)
        if n == 0:
            return 0.0
        return (
            sum(r.dispatch_overhead_us * r.requests for r in self.lane_reports)
            / n
        )

    @property
    def lane_qps(self) -> tuple[float, ...]:
        return tuple(r.achieved_qps for r in self.lane_reports)


@dataclasses.dataclass
class _LaneTally:
    """Mutable per-lane accounting a worker fills as it issues."""

    requests: int = 0
    dispatch_s: float = 0.0


def _run_workers(
    workers: Sequence[Callable[[], None]],
) -> None:
    """Run one thread per worker; re-raise the first worker error after
    every thread has joined (no half-drained lanes left behind)."""
    errors: list[BaseException] = []
    lock = threading.Lock()

    def guarded(fn: Callable[[], None]) -> Callable[[], None]:
        def run() -> None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in parent
                with lock:
                    errors.append(e)

        return run

    threads = [
        threading.Thread(target=guarded(fn), name=f"serve-lane-{i}", daemon=True)
        for i, fn in enumerate(workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def run_open_loop_threaded(
    call: Callable[[], Any],
    lane_schedules: Sequence[Schedule],
    *,
    concurrency: int = 32,
) -> ClientResult:
    """Open-loop serving with one issuing thread per lane.

    Each thread paces its own sub-schedule (``open_loop_lane_schedules``)
    against a shared start time; latency is recorded from the scheduled
    arrival, the standard open-loop convention. ``concurrency`` splits
    into per-lane window depths, as in the single-threaded client.
    """
    n_lanes = len(lane_schedules)
    if n_lanes < 1:
        raise ValueError("run_open_loop_threaded needs at least one lane schedule")
    depth = lane_depth(concurrency, n_lanes)
    sink = CompletionSink()
    tallies = [_LaneTally() for _ in range(n_lanes)]
    start = threading.Barrier(n_lanes)
    t0: list[float] = []

    def worker(lane_index: int) -> Callable[[], None]:
        lane = DispatchLane(lane_index, depth)
        schedule = lane_schedules[lane_index]
        tally = tallies[lane_index]

        def run() -> None:
            # All lanes leave the barrier together; the first one through
            # stamps the shared schedule origin.
            start.wait()
            if not t0:
                t0.append(time.perf_counter())
            origin = t0[0]
            done: list[Completion] = []  # lane-local; flushed once
            try:
                # One span per lane thread, recorded on the thread that
                # actually issued — the Chrome trace's tid attribution
                # for the threaded client comes from here.
                with current_tracer().span(
                    "serve.lane",
                    track="serve",
                    tid=f"lane {lane_index}",
                    lane=lane_index,
                ):
                    for req in schedule:
                        target = origin + req.arrival_s
                        delay = target - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                        d0 = time.perf_counter()
                        out = call()
                        tally.dispatch_s += time.perf_counter() - d0
                        tally.requests += 1
                        done.extend(lane.submit(out, req, target))
                        done.extend(lane.poll())
                    done.extend(lane.drain())
            finally:
                sink.add(done)

        return run

    _run_workers([worker(i) for i in range(n_lanes)])
    return _finalize(sink, tallies)


def run_closed_loop_threaded(
    call: Callable[[], Any],
    *,
    concurrency: int,
    n_lanes: int,
    duration_s: float,
    warmup: int = 0,
    max_requests: int | None = None,
) -> ClientResult:
    """Closed-loop serving with one issuing thread per lane.

    Each thread keeps its own lane's window (depth ``concurrency //
    n_lanes``) full until ``duration_s`` elapses. Request indices are
    striped (lane k issues k, k+N, k+2N, ...) so they stay globally
    unique without cross-thread coordination; each lane marks its first
    ``ceil(warmup / n_lanes)`` requests as warmup, covering at least the
    requested pipeline-fill exclusion. ``max_requests`` is an exact total
    cap (as in the single-threaded client): it is pre-split across lanes,
    the first ``max_requests % n_lanes`` lanes taking one extra request.
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    depth = lane_depth(concurrency, n_lanes)
    per_lane_warmup = -(-warmup // n_lanes)  # ceil
    per_lane_cap = [None] * n_lanes
    if max_requests is not None:
        per_lane_cap = [
            max_requests // n_lanes + (1 if k < max_requests % n_lanes else 0)
            for k in range(n_lanes)
        ]
    sink = CompletionSink()
    tallies = [_LaneTally() for _ in range(n_lanes)]
    start = threading.Barrier(n_lanes)

    def worker(lane_index: int) -> Callable[[], None]:
        lane = DispatchLane(lane_index, depth)
        tally = tallies[lane_index]
        cap = per_lane_cap[lane_index]

        def run() -> None:
            start.wait()
            deadline = time.perf_counter() + duration_s
            i = 0
            done: list[Completion] = []  # lane-local; flushed once
            try:
                with current_tracer().span(
                    "serve.lane",
                    track="serve",
                    tid=f"lane {lane_index}",
                    lane=lane_index,
                ):
                    while time.perf_counter() < deadline:
                        if cap is not None and i >= cap:
                            break
                        req = Request(
                            index=lane_index + i * n_lanes,
                            arrival_s=0.0,
                            warmup=i < per_lane_warmup,
                        )
                        t_submit = time.perf_counter()
                        d0 = t_submit
                        out = call()
                        tally.dispatch_s += time.perf_counter() - d0
                        tally.requests += 1
                        done.extend(lane.submit(out, req, t_submit))
                        done.extend(lane.poll())
                        i += 1
                    done.extend(lane.drain())
            finally:
                sink.add(done)

        return run

    _run_workers([worker(i) for i in range(n_lanes)])
    return _finalize(sink, tallies)


def _finalize(sink: CompletionSink, tallies: Sequence[_LaneTally]) -> ClientResult:
    # Per-lane QPS comes from the same helper the record column uses, so
    # LaneReport.achieved_qps and the row's lane_qps cannot drift apart.
    completions = sink.harvest()
    completions.sort(key=lambda c: c.t_done)
    qps = lane_qps_from_completions(completions, n_lanes=len(tallies))
    reports = tuple(
        LaneReport(
            lane=lane,
            requests=tally.requests,
            dispatch_overhead_us=(
                tally.dispatch_s / tally.requests * 1e6
                if tally.requests
                else 0.0
            ),
            achieved_qps=qps[lane],
        )
        for lane, tally in enumerate(tallies)
    )
    return ClientResult(completions=tuple(completions), lane_reports=reports)
