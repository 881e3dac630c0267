"""Deterministic load generation for the serving subsystem.

The port's copy of ``repro/serve/loadgen.py`` (numpy only), unchanged: the
same seed gives the same schedules in both packages.

Two canonical load models (the Milabench / serving-benchmark split):

- **open loop** (:func:`open_loop_schedule`): requests arrive on a Poisson
  process at a target QPS, independent of completions — the model that
  exposes queueing under overload. Interarrival gaps are drawn from a
  seeded ``numpy`` generator, so a schedule is *fully deterministic* for a
  fixed ``(qps, duration_s, seed)`` triple and reproducible across
  processes and platforms. The result is a :class:`Schedule`, which also
  carries a ``truncated`` flag: a schedule cut short at ``max_requests``
  offered *less* than the target QPS, and downstream statistics must say
  so rather than report the full target as the offered load.
- **per-lane open loop** (:func:`open_loop_lane_schedules`): the threaded
  client's variant — N independent Poisson streams at ``qps / N`` each,
  drawn from child RNGs spawned off one seed (``numpy`` ``SeedSequence``
  spawning, so lane k's stream is deterministic and independent of how
  the other lanes draw). The superposition of independent Poisson
  processes is Poisson at the summed rate, so the *merged* arrival
  process still offers the target QPS while each lane owns a stream it
  can issue without cross-thread coordination. Request indices and the
  warmup prefix are assigned in merged arrival order, so statistics see
  the same request stream a single-threaded client would.
- **closed loop** (:func:`closed_loop_schedule`): a fixed number of
  always-pending requests; the runner (``serve.lanes``) issues the next
  one the moment a slot frees, so arrival times are execution-driven and
  the schedule is just an indexed request list.

Warmup exclusion: the first ``warmup`` requests of either schedule are
flagged ``warmup=True``; latency statistics (``serve.latency``) drop them,
mirroring ``harness.time_fn``'s warmup iterations.

Mixed-shape traffic rides on top of either generator: :func:`sample_mix`
assigns every request a shape-bucket label drawn from a weighted
distribution with its *own* seeded stream (the arrival offsets are
untouched, so adding a mix never perturbs the arrival process), and
:func:`save_trace` / :func:`load_trace` persist the resulting
arrival+shape stream as replayable JSONL — two runs that load one trace
serve the identical request sequence, whatever their dispatch policy.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
from typing import Iterator, Mapping, Sequence, overload

import numpy as np

__all__ = [
    "Request",
    "Schedule",
    "open_loop_schedule",
    "open_loop_lane_schedules",
    "merge_schedules",
    "closed_loop_schedule",
    "sample_mix",
    "save_trace",
    "load_trace",
]

# Entropy appended to the plan seed for the shape-mix stream, so bucket
# draws are deterministic per seed yet independent of the arrival draws
# (the arrival stream is identical with and without a mix).
_MIX_STREAM = 0x5AAB


@dataclasses.dataclass(frozen=True)
class Request:
    """One generated request: arrival offset seconds from serve start
    (0.0 for closed-loop, where issue time is execution-driven), plus the
    shape-bucket label its inputs are drawn from (None = the single
    measure-stage shape)."""

    index: int
    arrival_s: float = 0.0
    warmup: bool = False
    bucket: str | None = None


@dataclasses.dataclass(frozen=True)
class Schedule(Sequence):
    """An ordered request stream plus the facts needed to interpret it:
    the per-stream offered QPS and whether generation was cut short at
    ``max_requests`` (``truncated=True`` means the stream offered *less*
    than ``offered_qps`` over the nominal duration)."""

    requests: tuple[Request, ...]
    offered_qps: float | None = None
    truncated: bool = False

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self) -> Iterator[Request]:
        return iter(self.requests)

    @overload
    def __getitem__(self, i: int) -> Request: ...

    @overload
    def __getitem__(self, i: slice) -> tuple[Request, ...]: ...

    def __getitem__(self, i):
        return self.requests[i]


def open_loop_schedule(
    *,
    qps: float,
    duration_s: float,
    seed: int = 0,
    warmup: int = 0,
    max_requests: int = 100_000,
) -> Schedule:
    """Poisson arrivals at ``qps`` for ``duration_s`` seconds.

    Deterministic for a fixed seed: the same triple always yields the same
    arrival offsets. ``max_requests`` bounds pathological qps*duration
    products (the schedule is materialized up front); hitting the bound
    sets ``truncated`` on the returned :class:`Schedule` so the run is
    reported as offering less than the target, not silently mislabeled.
    """
    _validate_open_loop(qps, duration_s)
    rng = np.random.default_rng(seed)
    arrivals = _poisson_arrivals(rng, qps, duration_s, max_requests)
    if not arrivals:
        # A duration too small for even one Poisson arrival is a valid
        # (if degenerate) request: return an explicitly empty schedule
        # rather than letting downstream stats raise a confusing error.
        # Empty is never "truncated" — nothing was cut short.
        return Schedule(requests=(), offered_qps=qps, truncated=False)
    requests = tuple(
        Request(index=i, arrival_s=t, warmup=i < warmup)
        for i, t in enumerate(arrivals)
    )
    return Schedule(
        requests=requests,
        offered_qps=qps,
        truncated=len(arrivals) >= max_requests,
    )


def open_loop_lane_schedules(
    *,
    qps: float,
    duration_s: float,
    n_lanes: int,
    seed: int = 0,
    warmup: int = 0,
    max_requests: int = 100_000,
) -> tuple[Schedule, ...]:
    """Split one open-loop load into ``n_lanes`` independent sub-streams.

    Lane k draws its own Poisson process at ``qps / n_lanes`` from a child
    RNG spawned off ``seed`` (``SeedSequence(seed).spawn``), so the merged
    arrival process is Poisson at the target QPS, each lane's stream is
    reproducible in isolation, and no thread ever coordinates with another
    to find its next arrival. Global request indices and the ``warmup``
    prefix are assigned in merged arrival order; ``max_requests`` caps the
    *merged* request count, and every lane's ``truncated`` flag reflects
    the merged truncation (the offered load is a property of the whole
    client, not one lane).
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    _validate_open_loop(qps, duration_s)
    lane_rate = qps / n_lanes
    rngs = [
        np.random.default_rng(child)
        for child in np.random.SeedSequence(seed).spawn(n_lanes)
    ]
    # Lazy heap-merge of the per-lane streams: each lane draws its next
    # gap only when its previous arrival is consumed, so hitting
    # ``max_requests`` materializes at most that many arrivals — the cap
    # keeps bounding pathological qps*duration products, per lane count.
    # Ties pop by lane index, deterministically. A lane's arrival
    # sequence is the same cumulative sum either way, so the streams are
    # identical to eager generation, just cut at the merged cap.
    heap: list[tuple[float, int]] = []
    for lane, rng in enumerate(rngs):
        t = float(rng.exponential(1.0 / lane_rate))
        if t < duration_s:
            heap.append((t, lane))
    heapq.heapify(heap)
    merged: list[tuple[float, int]] = []
    truncated = False
    while heap:
        if len(merged) >= max_requests:
            truncated = True  # more arrivals would have fit the duration
            break
        t, lane = heapq.heappop(heap)
        merged.append((t, lane))
        t_next = t + float(rngs[lane].exponential(1.0 / lane_rate))
        if t_next < duration_s:
            heapq.heappush(heap, (t_next, lane))
    per_lane: list[list[Request]] = [[] for _ in range(n_lanes)]
    for index, (t, lane) in enumerate(merged):
        per_lane[lane].append(
            Request(index=index, arrival_s=t, warmup=index < warmup)
        )
    return tuple(
        Schedule(
            requests=tuple(reqs),
            offered_qps=lane_rate,
            truncated=truncated,
        )
        for reqs in per_lane
    )


def merge_schedules(schedules: Sequence[Schedule]) -> Schedule:
    """The merged arrival stream of several sub-schedules, in arrival
    order — what the device sees when every lane issues its own stream.
    Offered QPS sums; truncation is sticky."""
    if not schedules:
        raise ValueError("merge_schedules needs at least one schedule")
    requests = tuple(
        sorted(
            (r for s in schedules for r in s.requests),
            key=lambda r: (r.arrival_s, r.index),
        )
    )
    offered = [s.offered_qps for s in schedules if s.offered_qps is not None]
    return Schedule(
        requests=requests,
        offered_qps=sum(offered) if offered else None,
        truncated=any(s.truncated for s in schedules),
    )


def closed_loop_schedule(n_requests: int, *, warmup: int = 0) -> tuple[Request, ...]:
    """``n_requests`` always-pending requests (arrival_s=0)."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    return tuple(
        Request(index=i, arrival_s=0.0, warmup=i < warmup)
        for i in range(n_requests)
    )


def sample_mix(
    schedule: Schedule,
    mix: Sequence[tuple[str, float]] | Mapping[str, float],
    *,
    seed: int = 0,
) -> Schedule:
    """Assign every request a shape-bucket label drawn from ``mix``.

    ``mix`` maps bucket label -> weight (weights need not sum to 1; they
    are normalized). Draws come from a dedicated stream seeded by
    ``(seed, _MIX_STREAM)`` — deterministic per seed, and independent of
    the arrival draws, so the arrival offsets of ``schedule`` are
    returned untouched. Bucket *order* matters for reproducibility:
    mappings are sorted by label first.
    """
    if isinstance(mix, Mapping):
        entries = sorted(mix.items())
    else:
        entries = list(mix)
    if not entries:
        raise ValueError("sample_mix needs at least one bucket")
    labels = [label for label, _ in entries]
    weights = np.array([w for _, w in entries], dtype=np.float64)
    if not (weights > 0).all():
        raise ValueError(f"mix weights must be > 0, got {entries}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, _MIX_STREAM]))
    picks = rng.choice(len(labels), size=len(schedule), p=weights / weights.sum())
    requests = tuple(
        dataclasses.replace(req, bucket=labels[int(pick)])
        for req, pick in zip(schedule.requests, picks)
    )
    return dataclasses.replace(schedule, requests=requests)


def save_trace(schedule: Schedule, path: str) -> None:
    """Persist a schedule as a replayable JSONL trace.

    Line 1 is a header object (``offered_qps``, ``truncated``, request
    count); every following line is one request (index / arrival_s /
    bucket / warmup). The format is append-only JSONL so traces diff and
    stream like the report files do.
    """
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        header = {
            "kind": "serve-trace",
            "offered_qps": schedule.offered_qps,
            "truncated": schedule.truncated,
            "requests": len(schedule),
        }
        fh.write(json.dumps(header) + "\n")
        for req in schedule:
            fh.write(
                json.dumps(
                    {
                        "index": req.index,
                        "arrival_s": req.arrival_s,
                        "bucket": req.bucket,
                        "warmup": req.warmup,
                    }
                )
                + "\n"
            )


def load_trace(path: str) -> Schedule:
    """Load a trace saved by :func:`save_trace` back into a
    :class:`Schedule` (bucket labels and warmup flags included) — the
    replay is exact, so loop/lanes/batcher runs over one trace serve the
    identical request stream."""
    with open(path, encoding="utf-8") as fh:
        lines = [line for line in fh if line.strip()]
    if not lines:
        raise ValueError(f"trace {path!r} is empty")
    header = json.loads(lines[0])
    if header.get("kind") != "serve-trace":
        raise ValueError(
            f"trace {path!r} does not look like a serve trace "
            f"(header kind={header.get('kind')!r})"
        )
    requests = tuple(
        Request(
            index=rec["index"],
            arrival_s=rec["arrival_s"],
            warmup=bool(rec.get("warmup", False)),
            bucket=rec.get("bucket"),
        )
        for rec in map(json.loads, lines[1:])
    )
    declared = header.get("requests")
    if declared is not None and declared != len(requests):
        raise ValueError(
            f"trace {path!r} is truncated on disk: header says "
            f"{declared} requests, file has {len(requests)}"
        )
    return Schedule(
        requests=requests,
        offered_qps=header.get("offered_qps"),
        truncated=bool(header.get("truncated", False)),
    )


def _validate_open_loop(qps: float, duration_s: float) -> None:
    if qps <= 0:
        raise ValueError(f"open-loop qps must be > 0, got {qps}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")


def _poisson_arrivals(
    rng: np.random.Generator, qps: float, duration_s: float, max_requests: int
) -> list[float]:
    out: list[float] = []
    t = 0.0
    while len(out) < max_requests:
        t += float(rng.exponential(1.0 / qps))
        if t >= duration_s:
            break
        out.append(t)
    return out
