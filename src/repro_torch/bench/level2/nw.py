"""Level 2: Needleman-Wunsch — global DNA sequence alignment (dynamic
programming).

Counterpart of ``repro/bench/level2/nw.py``: the score table's cell (i, j)
depends on its NW, N and W neighbours, so the schedule is the
anti-diagonal wavefront, the reference's ``lax.scan`` over 2n − 1
diagonals. Here the table is held by diagonals, (2n + 1) × (n + 1) int32,
with the boundary cells (i·GAP, j·GAP) and the cells off the table (NEG)
written before the sweep, and the match/mismatch scores of every cell
computed in one pass from the two sequences. Each diagonal's interior is
then one slice (static bounds) computed from the two before it, five
elementwise launches. The table takes the layout of the scores, so under
``torch.vmap`` (the serve stage's width-w call) each member sweeps a table of
its own. On the card the 2n − 1 diagonals are one CUDA graph
replay a call (:data:`GRAPHS`); on the CPU a plain loop. Integer
arithmetic: the score equals the reference's exactly.

``validate`` checks every size with a row-wise numpy DP (the reference
skips its Python oracle above n = 512).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graphs import GraphCache
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

MATCH, MISMATCH, GAP = 1, -1, -2
NEG = -(2**20)
GRAPHS = GraphCache()


def wavefront(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sweep, eagerly: the score of cell (n, n) as an int32 scalar."""
    n = a.shape[0]
    d = torch.arange(2 * n + 1, device=a.device)[:, None]  # diagonal: i + j
    i = torch.arange(n + 1, device=a.device)[None, :]  # position on it
    j = d - i
    # Every cell's substitution score (garbage off the table, never read).
    sub = torch.where(a[(i - 1).clamp(0, n - 1)] == b[(j - 1).clamp(0, n - 1)],
                      MATCH, MISMATCH).to(torch.int32)
    # The table takes sub's layout, so under torch.vmap it carries the batch
    # and every member sweeps its own; cells with i == 0 or j == 0 are final.
    table = torch.empty_like(sub).copy_(
        torch.where((j >= 0) & (j <= n), torch.where(i == 0, j * GAP, i * GAP), NEG))
    for k in range(2, 2 * n + 1):
        lo, hi = max(1, k - n), min(n, k - 1)  # interior cells: i in [lo, hi]
        nw = table[k - 2, lo - 1 : hi] + sub[k, lo : hi + 1]
        up_left = torch.maximum(table[k - 1, lo - 1 : hi], table[k - 1, lo : hi + 1]) + GAP
        table[k, lo : hi + 1] = torch.maximum(nw, up_left)
    return table[2 * n, n]


def nw_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Final alignment score of int sequences a, b (same length n)."""
    return GRAPHS.run(wavefront, a, b)


def host_score(a: np.ndarray, b: np.ndarray) -> int:
    """Row-wise DP in numpy: each row's west dependency is a running max,
    dp[i, j] = j·GAP + max over k ≤ j of (c[k] − k·GAP), c the row's best
    of its NW and N moves (c[0] the boundary i·GAP)."""
    n, m = len(a), len(b)
    cols = np.arange(m + 1, dtype=np.int64)
    row = cols * GAP
    for i in range(1, n + 1):
        c = np.empty(m + 1, np.int64)
        c[0] = i * GAP
        c[1:] = np.maximum(row[:-1] + np.where(b == a[i - 1], MATCH, MISMATCH), row[1:] + GAP)
        row = cols * GAP + np.maximum.accumulate(c - cols * GAP)
    return int(row[m])


def _make(n: int) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (
            torch.from_numpy(rng.integers(0, 4, n, dtype=np.int32)),
            torch.from_numpy(rng.integers(0, 4, n, dtype=np.int32)),
        )

    def validate(out, args):
        a, b = (x.cpu().numpy() for x in args)
        want = host_score(a, b)
        assert int(out) == want, (int(out), want)

    return Workload(
        name=f"nw.n{n}",
        fn=nw_score,
        make_inputs=make_inputs,
        flops=float(6 * n * n),
        bytes_moved=float(n * n * 4),
        validate=validate,
        # Opt out, as the reference: the wavefront is sequential.
        batch_dims=None,
        # fn replays a captured graph: a width-w serve call captures the
        # batched loop as one graph of its own (core/engine.py).
        meta={"graph_replay": True},
    )


register(
    BenchmarkSpec(
        name="nw",
        level=2,
        dwarf="Dynamic programming",
        domain="Bioinformatics",
        cuda_feature=None,
        gpu_feature="anti-diagonal wavefront as one CUDA graph replay",
        presets=geometric_presets({"n": 128}, scale_keys={"n": 2.0}, round_to=16),
        build=lambda n: _make(n),
    )
)
