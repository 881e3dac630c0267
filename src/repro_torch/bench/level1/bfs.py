"""Level 1: BFS — breadth-first search (the Unified-Memory benchmark).

Counterpart of ``repro/bench/level1/bfs.py``: frontier-parallel edge
relaxation over a uniform random digraph. Each level gathers the frontier
flag of every edge's source and marks the edges' destinations; a node
first marked at this level gets depth level + 1.

The reference's ``lax.while_loop`` runs until the frontier is empty, a
data-dependent trip count. Here it is a host-checked loop: one scalar read
(``frontier.any()``) a level, every other operation on the device. A node
counts as touched when at least one active edge ends there: ``index_add``
of the active flags as int32 counts (exact in any order), not an
``index_put_`` over duplicate destinations, where the last write would
win.

``validate`` runs a level-synchronous BFS in numpy over a CSR of the
graph, independent of the torch code. The reference's oracle walks the
edges in Python, minutes at preset 4 (2^25 edges).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

UNREACHED = 2**30


def make_random_graph(n_nodes: int, n_edges: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's graphs: the same numpy draws from the same seed."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    return src, dst


def bfs_host_reference(n_nodes: int, src: np.ndarray, dst: np.ndarray, root: int) -> np.ndarray:
    """Per-node depth (UNREACHED if none) by a level-synchronous BFS over
    the graph's CSR, in numpy."""
    order = np.argsort(src, kind="stable")
    targets = dst[order]
    starts = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_nodes), out=starts[1:])
    depth = np.full(n_nodes, UNREACHED, np.int64)
    depth[root] = 0
    frontier = np.array([root], np.int64)
    level = 0
    while frontier.size:
        level += 1
        lo, counts = starts[frontier], starts[frontier + 1] - starts[frontier]
        # The CSR slices of every frontier node, concatenated.
        first = np.repeat(lo - np.cumsum(counts) + counts, counts)
        nbrs = targets[first + np.arange(counts.sum())]
        frontier = np.unique(nbrs[depth[nbrs] == UNREACHED])
        depth[frontier] = level
    return depth


def bfs_depths(n_nodes: int, src: torch.Tensor, dst: torch.Tensor, root: int) -> torch.Tensor:
    """Frontier-parallel BFS: per-node depth (int32, UNREACHED if none)."""
    depth = torch.full((n_nodes,), UNREACHED, dtype=torch.int32, device=src.device)
    depth[root] = 0
    frontier = torch.zeros(n_nodes, dtype=torch.bool, device=src.device)
    frontier[root] = True
    level = 0
    while bool(frontier.any()):  # the loop's one host read a level
        active = frontier[src].to(torch.int32)
        touched = torch.zeros(n_nodes, dtype=torch.int32, device=src.device).index_add_(
            0, dst, active) > 0
        frontier = touched & (depth > level + 1)
        depth = torch.where(frontier, level + 1, depth)
        level += 1
    return depth


def _make(n_nodes: int, n_edges: int) -> Workload:
    def make_inputs(seed: int):
        return tuple(torch.from_numpy(a) for a in make_random_graph(n_nodes, n_edges, seed))

    def fn(src, dst):
        return bfs_depths(n_nodes, src, dst, root=0)

    def validate(out, args):
        src, dst = (a.cpu().numpy() for a in args)
        want = bfs_host_reference(n_nodes, src, dst, 0)
        np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), want)

    return Workload(
        name=f"bfs.n{n_nodes}.e{n_edges}",
        fn=fn,
        make_inputs=make_inputs,
        flops=2.0 * n_edges,  # the reference's count
        bytes_moved=8.0 * n_edges,
        validate=validate,
        # Opt out, as the reference: the frontier spans the whole graph.
        batch_dims=None,
    )


register(
    BenchmarkSpec(
        name="bfs",
        level=1,
        dwarf="Graph traversal",
        domain=None,
        cuda_feature="Unified Memory",
        gpu_feature="host-checked level loop, index_add relaxation",
        presets=geometric_presets(
            {"n_nodes": 1 << 10, "n_edges": 1 << 13},
            scale_keys={"n_nodes": 8.0, "n_edges": 8.0},
            round_to=64,
        ),
        build=lambda n_nodes, n_edges: _make(n_nodes, n_edges),
    )
)
