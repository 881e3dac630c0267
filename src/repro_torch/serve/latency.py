"""Per-request latency capture → serving statistics.

The port's copy of ``repro/serve/latency.py`` (numpy only), unchanged but
for its imports.

Folds a list of :class:`~repro_torch.serve.lanes.Completion` into the numbers a
serving benchmark reports: latency percentiles (p50/p95/p99/max over
non-warmup requests), achieved QPS (completions per measured second), and
goodput (completions under an optional latency SLO per measured second —
a request at exactly the SLO counts as good; without an SLO every
completed request is good, so goodput == achieved).

The measured window starts at the first non-warmup submission and ends at
the last completion, so pipeline fill (warmup) neither inflates latency
nor deflates throughput.

Honesty flags travel with the stats: ``truncated`` marks an open-loop run
whose schedule hit its request cap and therefore offered *less* than
``offered_qps``; ``dispatch_overhead_us`` / ``lane_qps`` carry the
client-side issue accounting (host time per dispatch, per-lane achieved
QPS) so host contention between lanes is a reported number.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.serve.lanes import Completion

__all__ = [
    "LatencyStats",
    "BucketStats",
    "stats_from_completions",
    "lane_qps_from_completions",
]


@dataclasses.dataclass(frozen=True)
class BucketStats:
    """Latency percentiles for one shape bucket's measured completions."""

    requests: int
    p50_us: float
    p95_us: float
    p99_us: float


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Serving statistics over one run's non-warmup completions."""

    requests: int  # measured (non-warmup) completions
    warmup_requests: int
    p50_us: float
    p95_us: float
    p99_us: float
    max_us: float
    achieved_qps: float
    goodput_qps: float  # completions under the SLO per second (== achieved without one)
    offered_qps: float | None = None  # open-loop target; None for closed loop
    slo_us: float | None = None  # the SLO goodput was measured against
    truncated: bool = False  # schedule hit its cap: offered < offered_qps
    dispatch_overhead_us: float | None = None  # mean host time per dispatch
    lane_qps: tuple[float, ...] | None = None  # per-lane achieved QPS
    # Mixed-shape serving (serve.batcher): per-bucket latency percentiles
    # keyed by bucket label, batch occupancy (filled / dispatched slots),
    # and padding waste (padded / dispatched slots). None outside the
    # bucketed paths.
    bucket_stats: tuple[tuple[str, "BucketStats"], ...] | None = None
    batch_occupancy: float | None = None
    padding_waste: float | None = None
    n_batches: int | None = None

    def derived(self) -> str:
        """The compact ``k=v;...`` form figure drivers put in CSV rows.

        ``offered_qps`` is emitted whenever it was set (``is not None`` —
        a 0.0 target must not vanish), ``goodput_qps`` whenever an SLO
        was in force, and ``truncated=1`` marks runs whose offered load
        fell short of the target.
        """
        parts = [
            f"requests={self.requests}",
            f"p50_us={self.p50_us:.1f}",
            f"p95_us={self.p95_us:.1f}",
            f"p99_us={self.p99_us:.1f}",
            f"qps={self.achieved_qps:.1f}",
        ]
        if self.offered_qps is not None:
            parts.append(f"offered_qps={self.offered_qps:.1f}")
        if self.slo_us is not None:
            parts.append(f"goodput_qps={self.goodput_qps:.1f}")
        if self.truncated:
            parts.append("truncated=1")
        if self.batch_occupancy is not None:
            parts.append(f"occupancy={self.batch_occupancy:.3f}")
        if self.padding_waste is not None:
            parts.append(f"padding_waste={self.padding_waste:.3f}")
        return ";".join(parts)


def stats_from_completions(
    completions: Sequence[Completion],
    *,
    offered_qps: float | None = None,
    slo_us: float | None = None,
    truncated: bool = False,
    dispatch_overhead_us: float | None = None,
    n_lanes: int | None = None,
    batch_occupancy: float | None = None,
    padding_waste: float | None = None,
    n_batches: int | None = None,
) -> LatencyStats:
    if not completions:
        raise ValueError(
            "no completions at all: the schedule was empty (duration too "
            "short for any arrival at this qps); raise --duration or --qps"
        )
    measured = [c for c in completions if not c.warmup]
    warmup = len(completions) - len(measured)
    if not measured:
        raise ValueError(
            f"no measured completions ({warmup} warmup-only); "
            "serve longer or lower the warmup count"
        )
    lat = np.array([c.latency_us for c in measured], dtype=np.float64)
    window_s = max(
        max(c.t_done for c in measured) - min(c.t_submit for c in measured),
        1e-9,
    )
    good = len(measured) if slo_us is None else int((lat <= slo_us).sum())
    by_bucket: dict[str, list[float]] = {}
    for c in measured:
        if c.bucket is not None:
            by_bucket.setdefault(c.bucket, []).append(c.latency_us)
    bucket_stats = (
        tuple(
            (
                label,
                BucketStats(
                    requests=len(lats),
                    p50_us=float(np.percentile(lats, 50)),
                    p95_us=float(np.percentile(lats, 95)),
                    p99_us=float(np.percentile(lats, 99)),
                ),
            )
            for label, lats in sorted(by_bucket.items())
        )
        if by_bucket
        else None
    )
    return LatencyStats(
        requests=len(measured),
        warmup_requests=warmup,
        p50_us=float(np.percentile(lat, 50)),
        p95_us=float(np.percentile(lat, 95)),
        p99_us=float(np.percentile(lat, 99)),
        max_us=float(lat.max()),
        achieved_qps=len(measured) / window_s,
        goodput_qps=good / window_s,
        offered_qps=offered_qps,
        slo_us=slo_us,
        truncated=truncated,
        dispatch_overhead_us=dispatch_overhead_us,
        lane_qps=lane_qps_from_completions(completions, n_lanes=n_lanes),
        bucket_stats=bucket_stats,
        batch_occupancy=batch_occupancy,
        padding_waste=padding_waste,
        n_batches=n_batches,
    )


def lane_qps_from_completions(
    completions: Sequence[Completion], *, n_lanes: int | None = None
) -> tuple[float, ...]:
    """Per-lane achieved QPS over each lane's own active window, indexed
    by lane — the column that shows whether lanes pulled equal weight or
    one issuing path starved the rest. A lane with no measured
    completions reads 0.0 (a starved lane is the finding, not a gap in
    the data); pass ``n_lanes`` to fix the length, else it spans the
    highest lane observed."""
    measured = [c for c in completions if not c.warmup]
    by_lane: dict[int, list[Completion]] = {}
    for c in measured:
        by_lane.setdefault(c.lane, []).append(c)
    count = (
        n_lanes if n_lanes is not None else max(by_lane, default=-1) + 1
    )
    out = []
    for lane in range(count):
        comps = by_lane.get(lane)
        if not comps:
            out.append(0.0)
            continue
        window = max(
            max(c.t_done for c in comps) - min(c.t_submit for c in comps),
            1e-9,
        )
        out.append(len(comps) / window)
    return tuple(out)
