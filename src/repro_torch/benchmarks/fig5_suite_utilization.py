"""Fig. 5: utilization characterization of the Mirovia suite's level 2.

Counterpart of ``benchmarks/fig5_suite_utilization.py``. The paper samples
nvprof's functional-unit utilization (0–10); the port, like the reference,
reports the compute/memory roofline split (0–10 bars) of each benchmark's
analytic counts against the card's peaks (``core/metrics.py``) beside the
measured time.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import Row, record_rows
from repro_torch.core.suite import run_suite

_LEVEL2 = [
    "cfd", "dwt2d_53", "dwt2d_97", "kmeans", "lavamd", "mandelbrot_flat",
    "mandelbrot_ms", "nw", "particlefilter", "srad", "where",
]


def rows(preset: int = 0, *, device: str = "cuda") -> list[Row]:
    records = run_suite(
        names=_LEVEL2, preset=preset, iters=3, warmup=1,
        include_backward=False, device=device, verbose=False,
    )
    return record_rows(
        "fig5",
        records,
        lambda r: (
            f"compute10={r.compute_util10};memory10={r.memory_util10};"
            f"dominant={r.dominant};gflops={r.achieved_gflops:.2f}"
        ),
    )
