"""Device-scaling figure: data-parallel throughput across device counts.

Counterpart of ``benchmarks/fig_scaling.py``, with its names and counts:
a sample of batchable benchmarks under ``placement=shard`` at each device
count of the sweep, and per (benchmark, count) the wall time and the
scaling efficiency against the same run's 1-device row (speedup over
devices; 1.0 is linear). ``bfs`` opts out of ``batch_dims`` and falls back
to replicate, showing the redundant-work floor (about 1/devices).

The devices are the ranks of the ``torch.distributed`` world this process
belongs to (``torchrun``; one device without it). Counts beyond the world
are left out, and the section says on stderr which and why: no row is made
for them. Rank 0 returns the rows; the other ranks run their share and
return none.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.benchmarks.run --device cpu --sections fig_scaling
"""

from __future__ import annotations

import sys

from repro_torch.benchmarks.common import Row, record_rows
from repro_torch.core.suite import run_suite
from repro_torch.runtime import sharding

# MXU-like (gemm), streaming (devicemem), mixed compute (kmeans), a row
# reduce (softmax), and one opted-out workload (bfs), as the reference.
DEFAULT_NAMES = ("gemm_f32_nn", "devicemem_stream", "kmeans", "softmax", "bfs")
DEFAULT_COUNTS = (1, 2, 4, 8)


def usable_counts(counts) -> tuple[int, ...]:
    """The counts this world can run (1 when none can), the rest named on
    stderr."""
    avail = sharding.available_devices()
    usable = tuple(c for c in counts if c <= avail)
    left_out = [c for c in counts if c > avail]
    if left_out and sharding.rank() == 0:
        print(f"# fig_scaling: counts {left_out} left out: {avail} device(s) available "
              "(the ranks of this torch.distributed world; start more with torchrun)",
              file=sys.stderr)
    return usable or (1,)


def rows(
    preset: int = 0,
    counts=DEFAULT_COUNTS,
    names=DEFAULT_NAMES,
    placement: str = "shard",
    device: str = "cuda",
    impl: str = "torch",
) -> list[Row]:
    records = run_suite(
        names=list(names),
        preset=preset,
        iters=3,
        warmup=1,
        include_backward=False,
        placement=placement,
        scale_devices=usable_counts(counts),
        impl=impl,
        device=device,
        verbose=False,
    )
    return record_rows(
        "fig_scaling",
        records,
        lambda r: (
            f"devices={r.devices};placement={r.placement};eff="
            + (f"{r.scaling_efficiency:.3f}" if r.scaling_efficiency is not None
               else "baseline")
        ),
    )
