"""DNN: LRN — local response normalisation forward and backward (paper eq. 3).

Counterpart of ``repro/bench/dnn/lrn.py``. The forward pass runs the
hand-written LRN kernel (``--impl kernel``) or the plain PyTorch oracle;
``validate`` holds the output against the oracle on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register
from repro_torch.kernels import ops, ref


def _make(n: int, c: int, hw: int):
    shape = (n, c, hw, hw)

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),)

    def fn(x):
        return ops.lrn(x)

    def validate(out, args):
        (x,) = args
        torch.testing.assert_close(out, ref.lrn_ref(x), rtol=1e-4, atol=1e-5)

    numel = float(n * c * hw * hw)
    return dnn_workload(
        f"lrn.{n}x{c}x{hw}x{hw}",
        fn,
        make_inputs,
        # The reference counts its TPU kernel's band matmul (2*C per
        # element); the count is kept so rows compare with its records.
        flops=numel * (2 * c + 6),
        bytes_moved=numel * 8,
        validate=validate,
        diff_argnums=(0,),
        batch_dims=(0,),
        kernel="lrn",
    )


register(
    BenchmarkSpec(
        name="lrn",
        level=2,
        dwarf="Unstructured Grid",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature="channel-window sum from a register ring, float4 columns (CUDA)",
        presets=geometric_presets(
            {"n": 8, "c": 32, "hw": 16}, scale_keys={"n": 2.0, "c": 2.0}, round_to=4
        ),
        build=lambda n, c, hw: _make(n, c, hw),
    )
)
