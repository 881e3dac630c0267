"""Level 2: Where — relational selection (data analytics, MapReduce dwarf).

Counterpart of ``repro/bench/level2/where.py``: map each record to 0/1
under a predicate, prefix-sum the flags with the hand-written scan kernel
(``--impl kernel``, ``kernels/prefix_scan.py``) or the plain oracle, and
compact the matching records to the front of a fixed-capacity output by a
scatter to the scanned offsets. The match count comes back beside the
records as a 0-d int32 tensor on the device, so the call never waits on
the host.

Validation, on the device: equal to the boolean-mask filter.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register
from repro_torch.kernels import ops


def where_select(records: torch.Tensor, lo: float, hi: float):
    """records (N, F); select rows with lo < records[:, 0] < hi.

    -> (selected rows first, zeros after them; the match count)."""
    n = records.shape[0]
    key = records[:, 0]
    flags = ((key > lo) & (key < hi)).float()
    offsets = ops.prefix_scan(flags)  # inclusive scan
    count = offsets[-1].to(torch.int32)
    # Exclusive position of each match; non-matches go to scratch row n.
    dest = torch.where(flags > 0, offsets.long() - 1, n)
    # Out of place, so that under torch.vmap each member scatters into its
    # own rows (an in-place copy into one unbatched zeros cannot).
    out = torch.index_copy(records.new_zeros((n + 1, records.shape[1])), 0, dest, records)
    # Matches fill rows [0, count) and nothing else is written below row n,
    # so the rows after the count are already the reference's zeros.
    return out[:n], count


def _make(n: int, fields: int) -> Workload:
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (torch.from_numpy(rng.random((n, fields), dtype=np.float32)),)

    def fn(records):
        return where_select(records, 0.25, 0.75)

    def validate(out, args):
        (records,) = args
        got, count = out
        mask = (records[:, 0] > 0.25) & (records[:, 0] < 0.75)
        want = records[mask]
        assert count.dtype == torch.int32 and count.dim() == 0, (count.dtype, count.shape)
        c = int(count)
        assert c == want.shape[0], (c, want.shape)
        torch.testing.assert_close(got[:c], want, rtol=1e-6, atol=0.0)
        assert bool((got[c:] == 0.0).all())

    return Workload(
        name=f"where.n{n}.f{fields}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(3 * n),
        bytes_moved=float(n * fields * 4 * 2),
        validate=validate,
        # Opt out, as the reference: the compaction scatters records to
        # offsets that depend on every earlier record.
        batch_dims=None,
        kernel="prefix_scan",
    )


register(
    BenchmarkSpec(
        name="where",
        level=2,
        dwarf="MapReduce",
        domain="Data Analytics",
        cuda_feature=None,
        gpu_feature="decoupled look-back prefix scan, then a scatter compaction (CUDA)",
        presets=geometric_presets(
            {"n": 1 << 12, "fields": 8}, scale_keys={"n": 8.0}, round_to=128
        ),
        build=lambda n, fields: _make(n, fields),
    )
)
