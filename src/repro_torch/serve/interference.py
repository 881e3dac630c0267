"""Co-location interference — the HyperQ §V-B experiment, suite-wide.

Counterpart of ``repro/serve/interference.py``. The paper co-locates
kernels on one GPU and measures how shared work queues degrade each
tenant. Here two workloads are served *concurrently* through disjoint
halves of a lane set, all enqueueing onto the card's current stream, so
device time is the shared resource; each tenant's slowdown is its
co-located latency over its isolated latency under the same per-tenant
load:

    slowdown(w) = p50_colocated(w) / p50_isolated(w)      (>= ~1.0)

:func:`colocate_closed_loop` runs the co-located measurement itself;
:func:`measure_colocation` wraps it with the two isolated baselines and
returns a :class:`ColocationResult` — what the engine's serve stage calls
under ``ServeSpec.colocate`` (and what ``benchmarks/fig_concurrency.py``
reaches through ``run_suite``). :func:`interference_matrix` maps a set of
callables to the full pairwise slowdown matrix.

Dispatch is single-threaded (tenants alternate submissions round-robin);
the concurrency measured is the card's, not the host's threads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

from repro_torch.serve.lanes import Completion, LaneSet, lane_depth, run_closed_loop
from repro_torch.serve.latency import LatencyStats, stats_from_completions
from repro_torch.serve.loadgen import Request

__all__ = [
    "ColocationResult",
    "colocate_closed_loop",
    "measure_colocation",
    "interference_matrix",
]


@dataclasses.dataclass(frozen=True)
class ColocationResult:
    """Isolated vs co-located serving statistics for one workload pair."""

    names: tuple[str, ...]
    isolated: Mapping[str, LatencyStats]
    colocated: Mapping[str, LatencyStats]

    def slowdown(self, name: str) -> float:
        base = self.isolated[name].p50_us
        return self.colocated[name].p50_us / base if base > 0 else 0.0

    def slowdowns(self) -> dict[str, float]:
        return {name: self.slowdown(name) for name in self.names}


def colocate_closed_loop(
    calls: Mapping[str, Callable[[], object]],
    *,
    concurrency: int,
    n_lanes: int,
    duration_s: float,
    warmup: int = 0,
) -> dict[str, list[Completion]]:
    """Serve every tenant closed-loop at once, splitting the lane set.

    Each of the K tenants gets ``n_lanes // K`` lanes (min 1) and
    ``concurrency // K`` in-flight slots (min 1), so total pressure on the
    device matches a single-tenant run at the same ServeSpec — the
    difference in latency is the interference.
    """
    if not calls:
        raise ValueError("colocate_closed_loop needs at least one tenant")
    k = len(calls)
    per_lanes = max(1, n_lanes // k)
    per_depth = lane_depth(max(1, concurrency // k), per_lanes)
    tenants = {
        name: (call, LaneSet(per_lanes, per_depth))
        for name, call in calls.items()
    }
    completions: dict[str, list[Completion]] = {name: [] for name in calls}
    counters = {name: 0 for name in calls}
    deadline = time.perf_counter() + duration_s
    while time.perf_counter() < deadline:
        for name, (call, lanes) in tenants.items():
            i = counters[name]
            req = Request(index=i, arrival_s=0.0, warmup=i < warmup)
            t_submit = time.perf_counter()
            completions[name].extend(lanes.submit(call(), req, t_submit))
            completions[name].extend(lanes.poll())
            counters[name] = i + 1
    # Final drain interleaves across tenants: draining A to empty before
    # touching B would stamp B's long-finished results with A's drain
    # time, inflating B's tail and skewing the slowdown ratio.
    lanesets = {name: lanes for name, (_, lanes) in tenants.items()}
    while any(ls.in_flight for ls in lanesets.values()):
        progressed = False
        for name, ls in lanesets.items():
            got = ls.poll()
            if got:
                completions[name].extend(got)
                progressed = True
        if not progressed:
            name, ls = min(
                ((n, l) for n, l in lanesets.items() if l.in_flight),
                key=lambda nl: nl[1].oldest_t_submit(),
            )
            completions[name].extend(ls.pop_oldest())
    return completions


def measure_colocation(
    calls: Mapping[str, Callable[[], object]],
    *,
    concurrency: int,
    n_lanes: int,
    duration_s: float,
    warmup: int = 0,
    slo_us: float | None = None,
) -> ColocationResult:
    """Isolated baselines (same per-tenant lanes/slots as the co-located
    run, so the only variable is the neighbour) + the co-located run.
    An SLO applies to both measurements, so each tenant's goodput is
    comparable across isolation and co-location."""
    k = len(calls)
    per_lanes = max(1, n_lanes // k)
    per_conc = max(1, concurrency // k)
    isolated = {
        name: stats_from_completions(
            run_closed_loop(
                call,
                concurrency=per_conc,
                n_lanes=per_lanes,
                duration_s=duration_s,
                warmup=warmup,
            ),
            slo_us=slo_us,
        )
        for name, call in calls.items()
    }
    together = colocate_closed_loop(
        calls,
        concurrency=concurrency,
        n_lanes=n_lanes,
        duration_s=duration_s,
        warmup=warmup,
    )
    colocated = {
        name: stats_from_completions(comps, slo_us=slo_us)
        for name, comps in together.items()
    }
    return ColocationResult(
        names=tuple(calls), isolated=isolated, colocated=colocated
    )


def interference_matrix(
    calls: Mapping[str, Callable[[], object]],
    *,
    concurrency: int,
    n_lanes: int,
    duration_s: float,
    warmup: int = 0,
    slo_us: float | None = None,
    pairs: Sequence[tuple[str, str]] | None = None,
) -> dict[tuple[str, str], ColocationResult]:
    """Pairwise co-location over ``calls`` (all unordered pairs by
    default) — the suite-wide slowdown-vs-isolated matrix."""
    names = list(calls)
    if pairs is None:
        pairs = [
            (a, b) for i, a in enumerate(names) for b in names[i + 1:]
        ]
    out: dict[tuple[str, str], ColocationResult] = {}
    for a, b in pairs:
        out[(a, b)] = measure_colocation(
            {a: calls[a], b: calls[b]},
            concurrency=concurrency,
            n_lanes=n_lanes,
            duration_s=duration_s,
            warmup=warmup,
            slo_us=slo_us,
        )
    return out
