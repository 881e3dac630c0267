"""Fig. 3: DNN forward-kernel utilization (the paper's cuDNN forward set).

Counterpart of ``benchmarks/fig3_dnn_forward.py``: the DNN section through
``run_suite`` on the torch path (the reference's default ``xla``), its
rows tagged ``fig3`` (``fig4`` for the backward pass).
"""

from __future__ import annotations

from repro_torch.benchmarks.common import Row, record_rows
from repro_torch.core.suite import run_suite

DNN = [
    "activation", "pooling", "batchnorm", "connected", "convolution_xla",
    "convolution_im2col", "dropout", "rnn", "softmax", "lrn",
]


def rows(preset: int = 0, backward: bool = False, *, device: str = "cuda") -> list[Row]:
    records = run_suite(
        names=DNN, preset=preset, iters=3, warmup=1,
        include_backward=backward, device=device, verbose=False,
    )
    tag = "fig4" if backward else "fig3"
    # Keep the pass this figure covers, and every error record (a build
    # failure has no .bwd row; hiding it would fake a clean section).
    records = [
        r
        for r in records
        if backward == r.name.endswith(".bwd") or r.status != "ok"
    ]
    return record_rows(
        tag,
        records,
        lambda r: (
            f"compute10={r.compute_util10};memory10={r.memory_util10};"
            f"dominant={r.dominant};gflops={r.achieved_gflops:.2f}"
        ),
    )
