"""Dispatch lanes — in-flight windows of device work, synchronized late.

Counterpart of ``repro/serve/lanes.py``, the HyperQ work-queue analogue on
JAX's async runtime. PyTorch's CUDA calls are asynchronous too: a call
enqueues its kernels on the current stream and returns, so a host thread
can keep many computations in flight and synchronize late. Where the
reference blocks on a result (``jax.block_until_ready``), the port records
a CUDA event on the current stream right after the call and later waits on
that event (``event.synchronize()``); where it polls (``is_ready``), the
port asks the event (``event.query()``). An event on the current stream
covers everything the call enqueued there, and a call that runs work on
side streams joins them into the current stream first
(``core.features.async_launch``). Results without CUDA tensors (host
objects, CPU tensors) are finished when the call returns and need no event.
A :class:`DispatchLane` models one work queue as an ordered window of
in-flight results; submitting to a full lane blocks on that lane's *own
oldest* result only, so the other lanes keep draining independently —
which is exactly what distinguishes N shallow queues from one deep one.

Three dispatch modes generalize the old ``feat_hyperq`` serial-loop-vs-
batched split:

- ``loop``   — synchronize after every call (:func:`serve_loop`); the
  no-concurrency baseline every speedup is measured against. With
  ``window=K`` it becomes the *windowed* floor: dispatch K requests back
  to back, synchronize once on all of them — the same
  amortize-the-sync move as ``harness.time_fn``'s windowed timing mode,
  so the gap between the two floors is the measured per-request
  dispatch + sync overhead of serial dispatch.
- ``lanes``  — N lanes × depth-D windows (:func:`run_closed_loop` /
  :func:`run_open_loop`); host dispatch overlaps device execution.
- ``batched``— N instances as one call via ``torch.vmap``
  (:func:`batched_call`, re-exported from ``core.features``); occupancy
  rather than dispatch concurrency.

All timestamps are ``time.perf_counter`` seconds; completion times are
observed either by a non-blocking ready poll (``event.query()``) or at the
blocking harvest, whichever comes first.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable

import torch

from repro_torch.core.features import concurrent_instances as batched_call  # noqa: F401
from repro_torch.core.features import cuda_tensors
from repro_torch.obs import current_tracer
from repro_torch.serve.loadgen import Request

__all__ = [
    "DISPATCH_MODES",
    "Completion",
    "DispatchLane",
    "LaneSet",
    "serve_loop",
    "run_closed_loop",
    "run_open_loop",
    "batched_call",
]

DISPATCH_MODES = ("loop", "lanes", "batched")


@dataclasses.dataclass(frozen=True)
class Completion:
    """One served request as observed by the dispatch loop."""

    index: int
    lane: int
    t_submit: float  # perf_counter seconds (scheduled arrival for open loop)
    t_done: float
    warmup: bool
    bucket: str | None = None  # shape bucket served (None = single-shape)

    @property
    def latency_us(self) -> float:
        return (self.t_done - self.t_submit) * 1e6


def _enqueued(out: Any) -> torch.cuda.Event | None:
    """An event recorded on the current stream of ``out``'s CUDA device,
    after the work the call that made ``out`` enqueued; None when ``out``
    holds no CUDA tensor (it was finished when the call returned)."""
    first = next(cuda_tensors(out), None)
    if first is None:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(first.device))
    return event


def _is_ready(event: torch.cuda.Event | None) -> bool:
    return event is None or event.query()


def _wait(event: torch.cuda.Event | None) -> None:
    if event is not None:
        event.synchronize()


class DispatchLane:
    """One work queue: an ordered window of up to ``depth`` in-flight
    computations. FIFO — only a ready *prefix* can ever be harvested."""

    def __init__(self, index: int, depth: int = 4) -> None:
        if depth < 1:
            raise ValueError(f"lane depth must be >= 1, got {depth}")
        self.index = index
        self.depth = depth
        # (request, submit time, event after its work or None)
        self._inflight: deque[tuple[Request, float, torch.cuda.Event | None]] = deque()

    def __len__(self) -> int:
        return len(self._inflight)

    @property
    def full(self) -> bool:
        return len(self._inflight) >= self.depth

    def submit(self, out: Any, request: Request, t_submit: float) -> list[Completion]:
        """Enqueue an already-dispatched computation; when the lane is at
        depth, first block on — and return — this lane's oldest result."""
        event = _enqueued(out)
        done = []
        if self.full:
            # The blocked-submit wall time is the lane-stall signal the
            # obs layer counts; guarded so the disabled cost is one
            # attribute read, with no timestamps taken.
            tracer = current_tracer()
            if tracer.enabled:
                b0 = time.perf_counter()
                done.append(self._finish(*self._inflight.popleft()))
                tracer.counters.inc(
                    "lane.submit_block_us", (time.perf_counter() - b0) * 1e6
                )
                tracer.counters.inc("lane.submit_blocks")
            else:
                done.append(self._finish(*self._inflight.popleft()))
        self._inflight.append((request, t_submit, event))
        return done

    def poll(self) -> list[Completion]:
        """Harvest ready results without blocking."""
        done = []
        while self._inflight and _is_ready(self._inflight[0][2]):
            done.append(self._finish(*self._inflight.popleft()))
        return done

    def oldest_t_submit(self) -> float:
        """Submit time of this lane's head (inf when empty)."""
        return self._inflight[0][1] if self._inflight else float("inf")

    def pop_oldest(self) -> list[Completion]:
        """Block on — and return — this lane's head, if any."""
        if not self._inflight:
            return []
        return [self._finish(*self._inflight.popleft())]

    def drain(self) -> list[Completion]:
        """Block on everything still in flight, oldest first."""
        done = []
        while self._inflight:
            done.append(self._finish(*self._inflight.popleft()))
        return done

    def _finish(self, request: Request, t_submit: float,
                event: torch.cuda.Event | None) -> Completion:
        _wait(event)
        return Completion(
            index=request.index,
            lane=self.index,
            t_submit=t_submit,
            t_done=time.perf_counter(),
            warmup=request.warmup,
            bucket=request.bucket,
        )


class LaneSet:
    """N dispatch lanes with least-loaded (round-robin tiebreak) submission."""

    def __init__(self, n_lanes: int, depth: int = 4) -> None:
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self.lanes = [DispatchLane(i, depth) for i in range(n_lanes)]
        self._rr = 0

    @property
    def in_flight(self) -> int:
        return sum(len(lane) for lane in self.lanes)

    @property
    def capacity(self) -> int:
        return sum(lane.depth for lane in self.lanes)

    def submit(self, out: Any, request: Request, t_submit: float) -> list[Completion]:
        n = len(self.lanes)
        lane = min(
            self.lanes, key=lambda l: (len(l), (l.index - self._rr) % n)
        )
        self._rr = (lane.index + 1) % n
        return lane.submit(out, request, t_submit)

    def poll(self) -> list[Completion]:
        return [c for lane in self.lanes for c in lane.poll()]

    def oldest_t_submit(self) -> float:
        return min(lane.oldest_t_submit() for lane in self.lanes)

    def pop_oldest(self) -> list[Completion]:
        """Block on the globally oldest in-flight head across lanes."""
        lane = min(self.lanes, key=DispatchLane.oldest_t_submit)
        return lane.pop_oldest()

    def drain(self) -> list[Completion]:
        """Harvest everything, interleaving across lanes: ready results
        first (prompt timestamps), then block on the globally oldest head
        — never fully draining one lane while another's finished results
        sit unstamped (that would charge lane 0's drain time to lane 1's
        latencies)."""
        done = []
        while self.in_flight:
            ready = self.poll()
            done.extend(ready if ready else self.pop_oldest())
        return done


def lane_depth(concurrency: int, n_lanes: int) -> int:
    """Per-lane window depth giving a total in-flight cap of ~concurrency."""
    return max(1, concurrency // max(n_lanes, 1))


def serve_loop(
    call: Callable[[], Any],
    requests: Iterable[Request],
    *,
    window: int = 1,
) -> list[Completion]:
    """``loop`` dispatch: synchronize after every call (no concurrency).

    ``window=K`` dispatches K requests back to back and synchronizes once
    on **all** of them (blocking only on the last could under-measure if
    the runtime completes computations out of order). Requests in a
    window share the window's completion stamp, so per-request latency
    becomes window-granular — use windowed loops for *throughput* floors
    (the per-call quotient), sync loops for latency floors.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out: list[Completion] = []
    if window == 1:
        for req in requests:
            t0 = time.perf_counter()
            _wait(_enqueued(call()))
            out.append(
                Completion(
                    index=req.index,
                    lane=0,
                    t_submit=t0,
                    t_done=time.perf_counter(),
                    warmup=req.warmup,
                    bucket=req.bucket,
                )
            )
        return out
    pending: list[tuple[Request, float, torch.cuda.Event | None]] = []

    def flush() -> None:
        if not pending:
            return
        for _, _, event in pending:
            _wait(event)
        t_done = time.perf_counter()
        out.extend(
            Completion(
                index=req.index, lane=0, t_submit=t0, t_done=t_done,
                warmup=req.warmup, bucket=req.bucket,
            )
            for req, t0, _ in pending
        )
        pending.clear()

    for req in requests:
        t0 = time.perf_counter()
        pending.append((req, t0, _enqueued(call())))
        if len(pending) >= window:
            flush()
    flush()
    return out


def run_closed_loop(
    call: Callable[[], Any],
    *,
    concurrency: int,
    n_lanes: int,
    duration_s: float,
    warmup: int = 0,
    max_requests: int | None = None,
) -> list[Completion]:
    """Closed-loop serving: keep ``concurrency`` requests in flight across
    ``n_lanes`` lanes until ``duration_s`` elapses (or ``max_requests``).

    The next request is issued as soon as the least-loaded lane has a free
    slot; a full lane blocks on its own oldest result, which *is* the slot
    freeing up. The first ``warmup`` requests are marked for exclusion.
    """
    lanes = LaneSet(n_lanes, lane_depth(concurrency, n_lanes))
    completions: list[Completion] = []
    deadline = time.perf_counter() + duration_s
    index = 0
    while time.perf_counter() < deadline:
        if max_requests is not None and index >= max_requests:
            break
        req = Request(index=index, arrival_s=0.0, warmup=index < warmup)
        t_submit = time.perf_counter()
        completions.extend(lanes.submit(call(), req, t_submit))
        completions.extend(lanes.poll())
        index += 1
    completions.extend(lanes.drain())
    return completions


def run_open_loop(
    call: Callable[[], Any],
    schedule: Iterable[Request],
    *,
    n_lanes: int,
    concurrency: int = 32,
) -> list[Completion]:
    """Open-loop serving: dispatch each request at its scheduled arrival.

    Pacing is best-effort — a dispatch that falls behind is *recorded from
    its scheduled arrival*, so queueing delay counts toward latency (the
    standard open-loop convention; closed-loop measurement hides it).
    ``concurrency`` caps total in-flight work so an overloaded run degrades
    by queueing on lanes rather than exhausting memory.
    """
    lanes = LaneSet(n_lanes, lane_depth(concurrency, n_lanes))
    completions: list[Completion] = []
    t0 = time.perf_counter()
    for req in schedule:
        target = t0 + req.arrival_s
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        completions.extend(lanes.submit(call(), req, target))
        completions.extend(lanes.poll())
    completions.extend(lanes.drain())
    return completions
