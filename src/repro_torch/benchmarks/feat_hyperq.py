"""§V-B HyperQ: concurrent Pathfinder instances.

Counterpart of ``benchmarks/feat_hyperq.py``. The paper launches N
Pathfinder kernels on N streams and sees the speedup saturate near the 32
hardware work queues. Each instance is one CUDA graph replay of the row
loop (``bench/level1/pathfinder.py::min_path_steps``); the sweep's four
ways of running N of them:

- ``loop_us`` (``serve.lanes.serve_loop``): one instance a call, the host
  waiting on an event after each: the no-concurrency baseline;
- ``windowed_us`` (``serve_loop(..., window=N)``): the same N calls back to
  back on one stream, one wait on all of them: the async-dispatch floor;
- ``batched_us`` (``core.features.concurrent_instances``): the N instances
  as one vmapped call, replayed as one graph: occupancy;
- ``streams_us`` (``core.features.async_launch``): instance i replayed on
  side stream i, the N graphs free to overlap on the card: the paper's own
  HyperQ measurement, which the reference names but cannot take.

Times are per sweep of N instances. ``max_connections`` is the value of
``CUDA_DEVICE_MAX_CONNECTIONS`` the process started with (the hardware
queues the streams map onto: 8 unless it was set, at most 32).

Graphs: this study keeps its own :class:`~repro_torch.core.graphs.GraphCache`
(the Pathfinder row's keeps 4, and 32 instances would evict each other on
every call). Every instance is a view of one stack of 32 grids, so instance
i has the same address, and so the same graph, at every N; all 32 and the
batched call's graph for each N are captured once, before any timing, and
never again. No graph is replayed on two streams at once: its static output
would be shared. Each row checks every instance's result against the plain
loop and raises if one differs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.bench.level1.pathfinder import host_min_path, min_path_steps
from repro_torch.benchmarks.common import Row
from repro_torch.core.features import async_launch
from repro_torch.core.graphs import GraphCache
from repro_torch.core.harness import time_fn
from repro_torch.serve.lanes import batched_call, serve_loop
from repro_torch.serve.latency import stats_from_completions
from repro_torch.serve.loadgen import closed_loop_schedule

INSTANCES = (1, 2, 4, 8, 16, 32)
ITERS, WARMUP = 5, 2  # the reference's
DEFAULT_CONNECTIONS = "8"  # CUDA's hardware connections unless the variable is set


def max_connections() -> str:
    return os.environ.get("CUDA_DEVICE_MAX_CONNECTIONS", DEFAULT_CONNECTIONS)


def rows(rows_grid: int = 64, cols: int = 256, *, instances: tuple[int, ...] = INSTANCES,
         device: str = "cuda", graphs: GraphCache | None = None) -> list[Row]:
    """``graphs``: the cache the replays go through (by default a new one
    holding every graph of the sweep)."""
    if graphs is None:
        graphs = GraphCache(capacity=2 * max(instances) + len(instances))
    rng = np.random.default_rng(0)
    stack_h = rng.integers(0, 10, (max(instances), rows_grid, cols), dtype=np.int32)
    stack = torch.from_numpy(stack_h).to(device)
    grids = list(stack)  # views: instance i keeps its address at every N
    want = [torch.from_numpy(host_min_path(g)) for g in stack_h]

    def single(grid: torch.Tensor) -> torch.Tensor:
        return graphs.run(min_path_steps, grid)

    def check(what: str, outs, n: int) -> None:
        for i, got in enumerate(outs):
            if not torch.equal(got.cpu(), want[i]):
                raise AssertionError(f"feat_hyperq n{n}: instance {i} differs ({what})")

    check("eager, then captured", [single(g).clone() for g in grids], len(grids))
    connections = max_connections()
    out: list[Row] = []
    for n in instances:
        # (a) loop: one instance a request, the host waiting on each; 2n
        # warm-up requests then 5 measured sweeps of n instances.
        state = {"i": 0}

        def call(n=n, state=state) -> torch.Tensor:
            i = state["i"] = (state["i"] + 1) % n
            return single(grids[i])

        stats = stats_from_completions(serve_loop(call, closed_loop_schedule(7 * n, warmup=2 * n)))
        us_loop = n * 1e6 / stats.achieved_qps  # per N-instance sweep

        # (b) windowed loop: the same calls, one wait a sweep.
        win = stats_from_completions(
            serve_loop(call, closed_loop_schedule(7 * n, warmup=2 * n), window=n))
        us_windowed = n * 1e6 / win.achieved_qps

        # (c) batched: the n instances as one vmapped call, one graph.
        batched = batched_call(min_path_steps, n)
        stacked = stack[:n]
        check("batched", graphs.run(batched, stacked), n)
        us_batch, _ = time_fn(graphs.run, (batched, stacked), iters=ITERS, warmup=WARMUP,
                              device=device)

        # (d) streams: instance i on side stream i, one join.
        args = [(g,) for g in grids[:n]]
        check("streams", [o.clone() for o in async_launch(single, args)], n)
        us_streams, _ = time_fn(async_launch, (single, args), iters=ITERS, warmup=WARMUP,
                                device=device)
        out.append(
            (
                f"feat_hyperq.n{n}",
                us_batch,
                f"instances={n};loop_us={us_loop:.1f};"
                f"windowed_us={us_windowed:.1f};batched_us={us_batch:.1f};"
                f"batching_speedup={us_loop / max(us_batch, 1e-9):.2f};"
                f"streams_us={us_streams:.1f};max_connections={connections}",
            )
        )
    return out

