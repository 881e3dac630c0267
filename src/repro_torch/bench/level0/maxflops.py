"""Level 0: MaxFlops — peak achievable FLOP/s.

Counterpart of ``repro/bench/level0/maxflops.py``: a chain of dependent
square matmuls (so nothing is elided), bf16 (the paper's "Half Precision"
case, on tensor cores) and f32. The reference's ``lax.fori_loop`` becomes a
Python loop of ``chain`` GEMM calls, each result rounded to the dtype
before the next, as the reference's loop carry is. The suite reports
achieved GFLOP/s; the roofline holds it against the card's peak for the
dtype (``core/metrics.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register
from repro_torch.kernels import ops


def _make(n: int, chain: int, dtype: str) -> Workload:
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        scale = np.float32(1.0 / (n**0.5))  # keep the chain numerically bounded
        a = rng.standard_normal((n, n), dtype=np.float32) * scale
        b = rng.standard_normal((n, n), dtype=np.float32) * scale
        return (torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt))

    def fn(a, b):
        acc = a
        for _ in range(chain):
            acc = ops.matmul(acc, b)
        return acc

    return Workload(
        name=f"maxflops.{dtype}.n{n}x{chain}",
        fn=fn,
        make_inputs=make_inputs,
        flops=2.0 * n * n * n * chain,
        bytes_moved=2.0 * n * n * dt.itemsize,
        batch_dims=(0, None),
        kernel="matmul",
    )


for _dtype in ("bf16", "f32"):
    register(
        BenchmarkSpec(
            name=f"maxflops_{_dtype}",
            level=0,
            dwarf=None,
            domain=None,
            cuda_feature="Half Precision" if _dtype == "bf16" else None,
            gpu_feature="bf16 tensor-core peak" if _dtype == "bf16" else "f32 FMA peak",
            presets=geometric_presets(
                {"n": 256, "chain": 4, "dtype": _dtype},
                scale_keys={"n": 2.0},
                round_to=128,
            ),
            build=functools.partial(_make),
        )
    )
