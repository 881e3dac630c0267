"""Concurrent-dispatch serving subsystem (paper §V-B generalized suite-wide).

Counterpart of ``repro/serve``, with its modules and exports:

- :mod:`repro_torch.serve.lanes` — dispatch lanes: in-flight windows of
  device work, each synchronized late on a CUDA event, with the ``loop`` /
  ``lanes`` / ``batched`` dispatch modes;
- :mod:`repro_torch.serve.loadgen` — deterministic seeded load generation
  (open-loop Poisson, per-lane sub-streams, closed loop, shape mixes and
  replayable traces), a copy of the reference's;
- :mod:`repro_torch.serve.client` — the thread-per-lane client
  (``run_open_loop_threaded`` / ``run_closed_loop_threaded``), every thread
  enqueueing on the device's current stream, with per-lane dispatch
  overhead measured;
- :mod:`repro_torch.serve.latency` — latency percentiles, achieved QPS and
  goodput from the completions, a copy of the reference's;
- :mod:`repro_torch.serve.interference` — co-located workload pairs on
  split lanes, and their slowdown against isolation;
- :mod:`repro_torch.serve.batcher` — continuous batching over mixed-shape
  traffic: per-bucket queues coalesced into ``torch.vmap`` calls of a
  bucket's width under a latency budget, with occupancy and padding waste
  measured per batch.

The engine (``core/engine.py``) drives all of this as a ``serve`` stage
after ``measure``, serving the measure stage's bound callable; the mixed
path builds one callable per (shape bucket, batch width) through the same
cache.
"""

from repro_torch.serve.client import (
    SERVE_CLIENTS,
    ClientResult,
    CompletionSink,
    LaneReport,
    run_closed_loop_threaded,
    run_open_loop_threaded,
)
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
from repro_torch.serve.interference import ColocationResult, colocate_closed_loop
from repro_torch.serve.batcher import (
    BatchExecution,
    BatchReport,
    bucket_widths,
    serve_dynamic,
    serve_fixed_batched,
    serve_mixed_lanes,
    serve_mixed_loop,
)

__all__ = [
    "DISPATCH_MODES",
    "SERVE_CLIENTS",
    "Completion",
    "DispatchLane",
    "LaneSet",
    "lane_depth",
    "run_closed_loop",
    "run_open_loop",
    "serve_loop",
    "ClientResult",
    "CompletionSink",
    "LaneReport",
    "run_closed_loop_threaded",
    "run_open_loop_threaded",
    "LatencyStats",
    "stats_from_completions",
    "Request",
    "Schedule",
    "closed_loop_schedule",
    "merge_schedules",
    "open_loop_lane_schedules",
    "open_loop_schedule",
    "ColocationResult",
    "colocate_closed_loop",
    "BucketStats",
    "sample_mix",
    "save_trace",
    "load_trace",
    "BatchExecution",
    "BatchReport",
    "bucket_widths",
    "serve_mixed_loop",
    "serve_mixed_lanes",
    "serve_fixed_batched",
    "serve_dynamic",
]
