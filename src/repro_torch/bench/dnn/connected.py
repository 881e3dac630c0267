"""DNN: Connected — fully-connected layer forward and backward.

Counterpart of ``repro/bench/dnn/connected.py``: x @ W + b, the matmul on
the hand-written GEMM kernel (``--impl kernel``) and the bias add in plain
PyTorch outside it, as the reference leaves it to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register
from repro_torch.kernels import ops


def _make(batch: int, din: int, dout: int):
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        s = np.float32(din**-0.5)
        return (
            torch.from_numpy(rng.standard_normal((batch, din), dtype=np.float32)),
            torch.from_numpy(s * rng.standard_normal((din, dout), dtype=np.float32)),
            torch.from_numpy(s * rng.standard_normal((dout,), dtype=np.float32)),
        )

    def fn(x, w, b):
        return ops.matmul(x, w) + b[None]

    def validate(out, args):
        x, w, b = (t.cpu().numpy() for t in args)
        np.testing.assert_allclose(
            out.cpu().numpy(), x @ w + b, rtol=2e-4, atol=2e-5
        )

    return dnn_workload(
        f"connected.b{batch}.{din}x{dout}",
        fn,
        make_inputs,
        flops=2.0 * batch * din * dout,
        bytes_moved=4.0 * (batch * din + din * dout + batch * dout),
        validate=validate,
        diff_argnums=(0, 1, 2),
        batch_dims=(0, None, None),
        kernel="matmul",
    )


register(
    BenchmarkSpec(
        name="connected",
        level=2,
        dwarf="Dense linear algebra",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature="f32 FMA register-blocked GEMM (CUDA)",
        presets=geometric_presets(
            {"batch": 64, "din": 256, "dout": 256},
            scale_keys={"batch": 2.0, "din": 2.0, "dout": 2.0},
            round_to=64,
        ),
        build=lambda batch, din, dout: _make(batch, din, dout),
    )
)
