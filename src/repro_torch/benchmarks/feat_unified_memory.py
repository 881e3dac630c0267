"""§V-B Unified Memory: BFS on a graph paged on demand, prefetched, and
resident on the card.

Counterpart of ``benchmarks/feat_unified_memory.py``. The paper compares
BFS with explicit copies against unified memory with and without advice and
prefetch, and finds demand paging wins only once prefetch is added. The
reference imitates managed memory with ``jax.device_put``; here the graph's
arrays live in real managed allocations (``core.features``):

- ``demand_us``: :class:`~repro_torch.core.features.DemandStager`, the
  graph's pages on the host at the call's start, faulted over to the card
  by the BFS's first kernels;
- ``prefetch_us``: :class:`~repro_torch.core.features.Prefetcher`, the card
  advised as the pages' preferred location and ``cudaMemPrefetchAsync`` of
  the graph to the card enqueued at the call's start, on a side stream the
  BFS waits for;
- ``resident_us``: the graph copied to device memory once (the paper's
  explicit-copy baseline, copy not timed).

Demand paging has to happen in every timed call: after one call the pages
live on the card and "demand" would cost nothing. So before each demand and
prefetch call, untimed, every page goes back to the host by a prefetch to
``cudaCpuDeviceId`` (``evict``). The reference instead overlaps the next
call's staging with this call's BFS; with the pages sent home between
calls there is nothing to overlap, and the prefetch is timed with its call.
``concurrent_managed_access`` is the card's
``cudaDevAttrConcurrentManagedAccess`` (where it is 0, pages move in bulk
at each launch and the prefetch raises; the CPU, which has no managed
memory, reports 0).

Each row holds the three depth vectors equal and raises otherwise.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from repro_torch.bench.level1.bfs import bfs_depths, make_random_graph
from repro_torch.benchmarks.common import Row
from repro_torch.core.features import DemandStager, Prefetcher
from repro_torch.core.harness import time_fn
from repro_torch.kernels import managed

# (nodes, edges): the reference's three graphs.
GRAPHS = ((1 << 10, 1 << 13), (1 << 13, 1 << 16), (1 << 15, 1 << 18))
ITERS, WARMUP = 5, 2  # the reference's


def _time_from(reset: Callable[[], None], fn: Callable[[], object], *, device: str) -> float:
    """Mean us a call of ``fn``, with ``reset()`` before each call, untimed
    (CUDA events around the call on the card, the host clock on the CPU)."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(WARMUP):
        reset()
        fn()
    samples = []
    for _ in range(ITERS):
        reset()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e6)
    return statistics.fmean(samples)


def _row(n_nodes: int, n_edges: int, device: str, concurrent: int) -> Row:
    src_h, dst_h = make_random_graph(n_nodes, n_edges, seed=0)

    def fn(s, d):
        return bfs_depths(n_nodes, s, d, 0)

    stager = DemandStager(device)

    def demand():
        return fn(stager.get(src_h), stager.get(dst_h))

    pf = Prefetcher(device)

    def prefetched():
        pf.prefetch("g", (src_h, dst_h))
        s, d = pf.get("g")
        return fn(s, d)

    resident = (torch.from_numpy(src_h).to(device), torch.from_numpy(dst_h).to(device))
    want = fn(*resident)
    for what, reset, call in (("demand", stager.evict, demand),
                              ("prefetch", pf.evict, prefetched)):
        reset()
        if not torch.equal(call(), want):
            raise AssertionError(f"feat_um n{n_nodes}: {what} depths differ from resident")
    us_demand = _time_from(stager.evict, demand, device=device)
    us_prefetch = _time_from(pf.evict, prefetched, device=device)
    us_resident, _ = time_fn(fn, resident, iters=ITERS, warmup=WARMUP, device=device)
    return (
        f"feat_um.bfs.n{n_nodes}",
        us_resident,
        f"demand_us={us_demand:.1f};prefetch_us={us_prefetch:.1f};"
        f"resident_us={us_resident:.1f};"
        f"prefetch_speedup_vs_demand={us_demand / max(us_prefetch, 1e-9):.2f};"
        f"concurrent_managed_access={concurrent}",
    )


def rows(graphs: tuple[tuple[int, int], ...] = GRAPHS, *, device: str = "cuda") -> list[Row]:
    cuda = torch.device(device).type == "cuda"
    concurrent = managed.concurrent_managed_access(device) if cuda else 0
    return [_row(n_nodes, n_edges, device, concurrent) for n_nodes, n_edges in graphs]
