"""Level 1: General Matrix Multiply (dense linear algebra dwarf).

Counterpart of ``repro/bench/level1/gemm.py``: f32 and bf16, with and
without a transposed A, on the hand-written GEMM kernel (``--impl kernel``)
or the plain PyTorch path (``--impl torch``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register
from repro_torch.kernels import ops

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _make(n: int, dtype: str, transpose: str) -> Workload:
    dt = _DTYPES[dtype]

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((n, n), dtype=np.float32)
        b = rng.standard_normal((n, n), dtype=np.float32)
        return (torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt))

    def fn(a, b):
        if "t" in transpose[:1]:  # "tn"/"tt": transpose A (a view, not a copy)
            a = a.T
        if transpose[1:] == "t":
            b = b.T
        return ops.matmul(a, b)

    # "nn" is data-parallel over a's rows; the transposed variants opt out
    # (a.T turns a's leading dim into the contraction dim).
    batch_dims = (0, None) if transpose == "nn" else None
    return Workload(
        name=f"gemm.{dtype}.{transpose}.n{n}",
        fn=fn,
        make_inputs=make_inputs,
        flops=2.0 * n**3,
        bytes_moved=3.0 * n * n * dt.itemsize,
        batch_dims=batch_dims,
        kernel="matmul",
    )


for _dtype in ("f32", "bf16"):
    for _tr in ("nn", "tn"):
        register(
            BenchmarkSpec(
                name=f"gemm_{_dtype}_{_tr}",
                level=1,
                dwarf="Dense linear algebra",
                domain=None,
                cuda_feature=None,
                gpu_feature=(
                    "TMA + wgmma bf16 tensor-core GEMM (CUDA)" if _dtype == "bf16"
                    else "TMA ring + f32 FMA GEMM, tile tuned (CUDA)"
                ),
                presets=geometric_presets(
                    {"n": 256, "dtype": _dtype, "transpose": _tr},
                    scale_keys={"n": 2.0},
                    round_to=128,
                ),
                build=lambda n, dtype, transpose: _make(n, dtype, transpose),
            )
        )
