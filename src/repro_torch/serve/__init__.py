"""Concurrent-dispatch serving, as far as the port has it.

Counterpart of ``repro/serve``. Ported so far, under the reference's names:

- :mod:`repro_torch.serve.lanes` — dispatch lanes: in-flight windows of
  device work, each synchronized late on a CUDA event, with the ``loop`` /
  ``lanes`` / ``batched`` dispatch modes (``serve_loop``, ``LaneSet``,
  ``run_closed_loop``, ``run_open_loop``);
- :mod:`repro_torch.serve.loadgen` — deterministic seeded load generation
  (open-loop Poisson, per-lane sub-streams, closed loop, shape mixes and
  replayable traces), a copy of the reference's;
- :mod:`repro_torch.serve.latency` — latency percentiles, achieved QPS and
  goodput from the completions, a copy of the reference's.

The HyperQ study (``repro_torch/benchmarks/feat_hyperq.py``) drives them.
The threaded client, the batcher, co-location and the engine's serve stage
are not ported yet.
"""

from repro_torch.serve.lanes import (
    DISPATCH_MODES,
    Completion,
    DispatchLane,
    LaneSet,
    lane_depth,
    run_closed_loop,
    run_open_loop,
    serve_loop,
)
from repro_torch.serve.latency import BucketStats, LatencyStats, stats_from_completions
from repro_torch.serve.loadgen import (
    Request,
    Schedule,
    closed_loop_schedule,
    load_trace,
    merge_schedules,
    open_loop_lane_schedules,
    open_loop_schedule,
    sample_mix,
    save_trace,
)

__all__ = [
    "DISPATCH_MODES",
    "Completion",
    "DispatchLane",
    "LaneSet",
    "lane_depth",
    "run_closed_loop",
    "run_open_loop",
    "serve_loop",
    "BucketStats",
    "LatencyStats",
    "stats_from_completions",
    "Request",
    "Schedule",
    "closed_loop_schedule",
    "load_trace",
    "merge_schedules",
    "open_loop_lane_schedules",
    "open_loop_schedule",
    "sample_mix",
    "save_trace",
]
