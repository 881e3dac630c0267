"""Level 1: Pathfinder — shortest path down a grid (the HyperQ benchmark).

Counterpart of ``repro/bench/level1/pathfinder.py``: the dynamic-programming
row sweep dist'[j] = w[i, j] + min(dist[j-1..j+1]), edges clamped. The
reference's ``lax.scan`` over rows has a static trip count; on the card
the whole row loop (rows − 1 steps of five small elementwise launches) is
one CUDA graph replay a call (:data:`GRAPHS`), keyed on the grid's address
and layout. On the CPU it is a plain loop. Integer arithmetic: both
packages give the same distances exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graphs import GraphCache
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

GRAPHS = GraphCache()


def min_path_steps(grid: torch.Tensor) -> torch.Tensor:
    """The row loop, eagerly: min path cost entering anywhere in row 0."""
    dist = grid[0]
    for row in grid[1:]:
        left = torch.cat([dist[:1], dist[:-1]])
        right = torch.cat([dist[1:], dist[-1:]])
        dist = row + torch.minimum(dist, torch.minimum(left, right))
    return dist


def pathfinder_min_path(grid: torch.Tensor) -> torch.Tensor:
    """:func:`min_path_steps`, one graph replay on a CUDA grid."""
    return GRAPHS.run(min_path_steps, grid)


def host_min_path(grid: np.ndarray) -> np.ndarray:
    """The reference's numpy oracle."""
    dist = grid[0].copy()
    for row in grid[1:]:
        left = np.concatenate([dist[:1], dist[:-1]])
        right = np.concatenate([dist[1:], dist[-1:]])
        dist = row + np.minimum(dist, np.minimum(left, right))
    return dist


def _make(rows: int, cols: int) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (torch.from_numpy(rng.integers(0, 10, (rows, cols), dtype=np.int32)),)

    def validate(out, args):
        (grid,) = args
        np.testing.assert_array_equal(out.cpu().numpy(), host_min_path(grid.cpu().numpy()))

    return Workload(
        name=f"pathfinder.{rows}x{cols}",
        fn=pathfinder_min_path,
        make_inputs=make_inputs,
        flops=4.0 * rows * cols,
        bytes_moved=4.0 * rows * cols,
        validate=validate,
        # Opt out, as the reference: rows are the sequential axis and each
        # step mixes neighbouring columns.
        batch_dims=None,
        # fn replays a captured graph: a width-w serve call captures the
        # batched loop as one graph of its own (core/engine.py).
        meta={"graph_replay": True},
    )


register(
    BenchmarkSpec(
        name="pathfinder",
        level=1,
        dwarf="Dynamic programming",
        domain=None,
        cuda_feature="HyperQ",
        gpu_feature="row loop as one CUDA graph replay",
        presets=geometric_presets(
            {"rows": 64, "cols": 1024},
            scale_keys={"rows": 2.0, "cols": 4.0},
            round_to=16,
        ),
        build=lambda rows, cols: _make(rows, cols),
    )
)
