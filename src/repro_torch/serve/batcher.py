"""Continuous batching over shape-bucketed callables.

Counterpart of ``repro/serve/batcher.py``: bursty arrivals of
*heterogeneous* request sizes, coalesced into batches before they reach the
card. Every function here consumes a mixed-shape
:class:`~repro_torch.serve.loadgen.Schedule` (each request tagged with a
shape bucket label) plus a table of zero-arg callables,
``calls[bucket][width]`` — one ``torch.vmap`` call per (shape bucket, batch
width), built by the engine through its callable cache.

Four dispatch policies, lowest to highest coalescing:

- :func:`serve_mixed_loop` — synchronize after every request (width 1);
  the no-concurrency floor every batching speedup is measured against.
- :func:`serve_mixed_lanes` — width-1 dispatch through a
  :class:`~repro_torch.serve.lanes.LaneSet`: host/device overlap but no
  coalescing.
- :func:`serve_fixed_batched` — a fixed-width call per bucket that waits
  for a full batch; only the end-of-stream flush pads.
- :func:`serve_dynamic` — the continuous batcher: per-bucket queues,
  dispatched into the *largest* power-of-two width that fits under a
  latency budget. A batch goes out when its queue can fill ``max_batch``
  or when its oldest request has waited ``budget_s``; a partial batch is
  padded up to the smallest width that holds it.

Where the reference blocks on a batch's result (``jax.block_until_ready``)
the port waits on the CUDA event recorded on the current stream right after
the batch's call, and where it polls (``is_ready``) it queries that event
(``serve/lanes.py``: ``_enqueued``, ``_is_ready``, ``_wait``). A result
without CUDA tensors (a CPU run) has no event and is ready when the call
returns.

Padding is **measured, not hidden**: every dispatched batch is recorded as
a :class:`BatchExecution` with its width (slots the call computes) and fill
(slots carrying real requests), and :class:`BatchReport` aggregates them
into ``occupancy`` (filled / total slots) and ``padding_waste`` (padded /
total slots == 1 - occupancy). Latencies are stamped from each request's
*scheduled arrival*, so time spent waiting in a coalescing queue counts
toward latency.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.serve.lanes import Completion, LaneSet, _enqueued, _is_ready, _wait, lane_depth
from repro_torch.serve.loadgen import Request, Schedule

__all__ = [
    "BatchExecution",
    "BatchReport",
    "bucket_widths",
    "serve_mixed_loop",
    "serve_mixed_lanes",
    "serve_fixed_batched",
    "serve_dynamic",
]

# Poll interval while waiting for arrivals / in-flight batches: long
# enough not to burn a core spinning, short enough (100 us) to be noise
# against the multi-ms latency budgets this path measures.
_POLL_S = 1e-4


@dataclasses.dataclass(frozen=True)
class BatchExecution:
    """One dispatched device program: ``width`` slots computed, ``filled``
    of them carrying real requests (the rest are padding). ``cause`` says
    *why* the batch went out — ``full`` (the queue could fill the largest
    width), ``expired`` (the oldest request hit the latency budget), or
    ``flush`` (end of stream) — so budget expiries are countable in the
    trace, not inferred from fill ratios."""

    bucket: str
    width: int
    filled: int
    t_dispatch: float
    t_done: float
    cause: str = "full"

    def __post_init__(self) -> None:
        if not 1 <= self.filled <= self.width:
            raise ValueError(
                f"batch fill must be in [1, width={self.width}], "
                f"got {self.filled}"
            )


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """Everything one serving run dispatched, with the padding accounted."""

    completions: tuple[Completion, ...]
    batches: tuple[BatchExecution, ...]

    @property
    def total_slots(self) -> int:
        return sum(b.width for b in self.batches)

    @property
    def filled_slots(self) -> int:
        return sum(b.filled for b in self.batches)

    @property
    def occupancy(self) -> float:
        """Filled / total dispatched slots (1.0 = no padding ever)."""
        total = self.total_slots
        return self.filled_slots / total if total else 0.0

    @property
    def padding_waste(self) -> float:
        """Padded / total dispatched slots (== 1 - occupancy)."""
        total = self.total_slots
        return (total - self.filled_slots) / total if total else 0.0

    @property
    def mean_width(self) -> float:
        return self.total_slots / len(self.batches) if self.batches else 0.0


def bucket_widths(dispatch: str, max_batch: int) -> tuple[int, ...]:
    """The batch widths a dispatch policy needs compiled per bucket:
    powers of two up to ``max_batch`` for the dynamic batcher (its pad
    targets), just ``max_batch`` for the fixed-width mode, width 1 for
    the uncoalesced policies."""
    if dispatch == "dynamic":
        widths = [1]
        while widths[-1] * 2 <= max_batch:
            widths.append(widths[-1] * 2)
        if widths[-1] != max_batch:
            widths.append(max_batch)  # non-power-of-two edge stays reachable
        return tuple(widths)
    if dispatch == "batched":
        return (max_batch,)
    return (1,)


CallTable = Mapping[str, Mapping[int, Callable[[], Any]]]


def _call(calls: CallTable, bucket: str, width: int) -> Any:
    try:
        return calls[bucket][width]()
    except KeyError:
        raise KeyError(
            f"no executable for bucket={bucket!r} width={width}; "
            f"have {sorted((b, w) for b in calls for w in calls[b])}"
        ) from None


def serve_mixed_loop(calls: CallTable, schedule: Schedule) -> BatchReport:
    """``loop`` dispatch over a mixed-shape schedule: wait for each
    request's scheduled arrival, run its bucket's width-1 program,
    synchronize, repeat. Every batch is width 1 and fully occupied, so
    occupancy is 1.0 by construction — the floor the batcher's
    amortization is measured against."""
    completions: list[Completion] = []
    batches: list[BatchExecution] = []
    t0 = time.perf_counter()
    for req in schedule:
        target = t0 + req.arrival_s
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t_dispatch = time.perf_counter()
        _wait(_enqueued(_call(calls, req.bucket, 1)))
        t_done = time.perf_counter()
        completions.append(
            Completion(
                index=req.index, lane=0, t_submit=target, t_done=t_done,
                warmup=req.warmup, bucket=req.bucket,
            )
        )
        batches.append(
            BatchExecution(
                bucket=req.bucket, width=1, filled=1,
                t_dispatch=t_dispatch, t_done=t_done,
            )
        )
    return BatchReport(tuple(completions), tuple(batches))


def serve_mixed_lanes(
    calls: CallTable,
    schedule: Schedule,
    *,
    n_lanes: int,
    concurrency: int = 32,
) -> BatchReport:
    """``lanes`` dispatch over a mixed-shape schedule: each request's
    width-1 program goes into the least-loaded dispatch lane at its
    scheduled arrival (the :func:`~repro_torch.serve.lanes.run_open_loop`
    policy, with the call chosen per request bucket). Overlap without
    coalescing: width-1 batches, occupancy 1.0."""
    lanes = LaneSet(n_lanes, lane_depth(concurrency, n_lanes))
    completions: list[Completion] = []
    batches: list[BatchExecution] = []
    t0 = time.perf_counter()
    for req in schedule:
        target = t0 + req.arrival_s
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t_dispatch = time.perf_counter()
        completions.extend(lanes.submit(_call(calls, req.bucket, 1), req, target))
        completions.extend(lanes.poll())
        batches.append(
            BatchExecution(
                bucket=req.bucket, width=1, filled=1,
                t_dispatch=t_dispatch, t_done=t_dispatch,
            )
        )
    completions.extend(lanes.drain())
    return BatchReport(tuple(completions), tuple(batches))


class _InflightBatches:
    """FIFO window of dispatched batches, capped by in-flight *requests*
    (padding slots do not count against the cap — they are waste, not
    work the client asked for). Each batch is held with the CUDA event
    recorded after its call (None for a result with no CUDA tensor)."""

    def __init__(self, max_inflight_requests: int) -> None:
        self.cap = max(1, max_inflight_requests)
        self._inflight: deque[
            tuple[list[Request], str, int, float, str, torch.cuda.Event | None]
        ] = deque()

    @property
    def inflight_requests(self) -> int:
        return sum(len(members) for members, *_ in self._inflight)

    def add(
        self, members: list[Request], bucket: str, width: int,
        t_dispatch: float, cause: str, out: Any,
    ) -> None:
        self._inflight.append((members, bucket, width, t_dispatch, cause, _enqueued(out)))

    def poll(self, t0: float) -> tuple[list[Completion], list[BatchExecution]]:
        done_c: list[Completion] = []
        done_b: list[BatchExecution] = []
        while self._inflight and _is_ready(self._inflight[0][5]):
            c, b = self._finish(t0, *self._inflight.popleft())
            done_c.extend(c)
            done_b.append(b)
        return done_c, done_b

    def pop_oldest(self, t0: float) -> tuple[list[Completion], list[BatchExecution]]:
        if not self._inflight:
            return [], []
        c, b = self._finish(t0, *self._inflight.popleft())
        return c, [b]

    def drain(self, t0: float) -> tuple[list[Completion], list[BatchExecution]]:
        done_c: list[Completion] = []
        done_b: list[BatchExecution] = []
        while self._inflight:
            c, b = self._finish(t0, *self._inflight.popleft())
            done_c.extend(c)
            done_b.append(b)
        return done_c, done_b

    def _finish(
        self, t0: float, members: list[Request], bucket: str, width: int,
        t_dispatch: float, cause: str, event: torch.cuda.Event | None,
    ) -> tuple[list[Completion], BatchExecution]:
        _wait(event)
        t_done = time.perf_counter()
        completions = [
            Completion(
                index=req.index, lane=0, t_submit=t0 + req.arrival_s,
                t_done=t_done, warmup=req.warmup, bucket=bucket,
            )
            for req in members
        ]
        batch = BatchExecution(
            bucket=bucket, width=width, filled=len(members),
            t_dispatch=t_dispatch, t_done=t_done, cause=cause,
        )
        return completions, batch


def _coalescing_serve(
    calls: CallTable,
    schedule: Schedule,
    *,
    widths_by_bucket: Mapping[str, Sequence[int]],
    budget_s: float,
    concurrency: int,
) -> BatchReport:
    """The shared batched/dynamic core: per-bucket FIFO queues, dispatch
    when a queue can fill its largest width or its oldest request has
    waited ``budget_s`` (or the stream ended — the flush), pad a partial
    batch up to the smallest compiled width that holds it."""
    queues: dict[str, deque[Request]] = {b: deque() for b in widths_by_bucket}
    inflight = _InflightBatches(concurrency)
    completions: list[Completion] = []
    batches: list[BatchExecution] = []
    requests = schedule.requests
    i = 0
    t0 = time.perf_counter()

    def harvest(pairs: tuple[list[Completion], list[BatchExecution]]) -> None:
        completions.extend(pairs[0])
        batches.extend(pairs[1])

    def dispatch(bucket: str, cause: str) -> None:
        widths = widths_by_bucket[bucket]
        q = queues[bucket]
        take = min(len(q), max(widths))
        width = min(w for w in widths if w >= take)
        members = [q.popleft() for _ in range(take)]
        # Retire old batches until this one fits the in-flight window. A
        # batch wider than the whole cap dispatches alone once the window
        # is empty (the cap bounds concurrency, it cannot shrink a batch).
        while inflight.inflight_requests and (
            inflight.inflight_requests + take > inflight.cap
        ):
            harvest(inflight.pop_oldest(t0))
        t_dispatch = time.perf_counter()
        inflight.add(
            members, bucket, width, t_dispatch, cause,
            _call(calls, bucket, width),
        )

    while i < len(requests) or any(queues.values()) or inflight.inflight_requests:
        now = time.perf_counter()
        while i < len(requests) and t0 + requests[i].arrival_s <= now:
            req = requests[i]
            if req.bucket not in queues:
                raise KeyError(
                    f"request {req.index} has bucket {req.bucket!r} with no "
                    f"compiled executables; have {sorted(queues)}"
                )
            queues[req.bucket].append(req)
            i += 1
        harvest(inflight.poll(t0))
        stream_done = i >= len(requests)
        dispatched = False
        for bucket, q in queues.items():
            if not q:
                continue
            full = len(q) >= max(widths_by_bucket[bucket])
            expired = now - (t0 + q[0].arrival_s) >= budget_s
            if full or expired or stream_done:
                dispatch(
                    bucket,
                    "full" if full else ("expired" if expired else "flush"),
                )
                dispatched = True
        if dispatched:
            continue
        # Nothing ready: sleep until the next arrival or the oldest
        # queue deadline, in short slices so in-flight polls stay live.
        next_arrival = (
            t0 + requests[i].arrival_s if i < len(requests) else float("inf")
        )
        oldest = min(
            (t0 + q[0].arrival_s + budget_s for q in queues.values() if q),
            default=float("inf"),
        )
        wake = min(next_arrival, oldest)
        delay = wake - time.perf_counter()
        if delay > 0:
            time.sleep(min(delay, _POLL_S) if inflight.inflight_requests else min(delay, 0.01))
    harvest(inflight.drain(t0))
    return BatchReport(tuple(completions), tuple(batches))


def serve_fixed_batched(
    calls: CallTable,
    schedule: Schedule,
    *,
    batch: int,
    concurrency: int = 32,
) -> BatchReport:
    """``batched`` dispatch: one fixed-width vmap per bucket that waits
    for a full batch before dispatching — occupancy over concurrency, the
    ``serve/lanes.py`` docstring's third mode, with its occupancy
    reported. Only the end-of-stream flush dispatches a padded
    partial batch, and that padding shows up in ``padding_waste``."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    widths = {b: (batch,) for b in calls}
    return _coalescing_serve(
        calls, schedule,
        widths_by_bucket=widths,
        budget_s=float("inf"),
        concurrency=concurrency,
    )


def serve_dynamic(
    calls: CallTable,
    schedule: Schedule,
    *,
    budget_s: float,
    concurrency: int = 32,
) -> BatchReport:
    """Continuous batching: coalesce queued requests of one bucket into
    the largest compiled width available, but never hold a request past
    ``budget_s`` — when the oldest queued request's wait hits the budget,
    the batch goes out at whatever fill it has, padded up to the smallest
    width that holds it. The budget is the latency/efficiency dial:
    0 degenerates to eager width-1 dispatch, infinity to fixed-width
    batching."""
    if budget_s < 0:
        raise ValueError(f"budget_s must be >= 0, got {budget_s}")
    widths = {b: tuple(sorted(calls[b])) for b in calls}
    return _coalescing_serve(
        calls, schedule,
        widths_by_bucket=widths,
        budget_s=budget_s,
        concurrency=concurrency,
    )
