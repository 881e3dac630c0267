"""DNN: Activation — ReLU forward and backward (paper eq. 1).

Counterpart of ``repro/bench/dnn/activation.py``: ``torch.relu``. It has no
hand-written kernel, as the reference has none, so ``--impl kernel`` rows
time torch and say ``impl_fallback="no_kernel"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register


def _make(n: int, c: int, hw: int):
    shape = (n, c, hw, hw)

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),)

    def fn(x):
        return torch.relu(x)

    def validate(out, args):
        (x,) = args
        assert torch.equal(out, torch.clamp_min(x, 0.0)), "relu output differs"

    numel = float(n * c * hw * hw)
    return dnn_workload(
        f"activation.relu.{n}x{c}x{hw}x{hw}",
        fn,
        make_inputs,
        flops=numel,
        bytes_moved=numel * 8,
        validate=validate,
        diff_argnums=(0,),
        batch_dims=(0,),
    )


register(
    BenchmarkSpec(
        name="activation",
        level=2,
        dwarf="Unstructured Grid",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature=None,
        presets=geometric_presets(
            {"n": 8, "c": 16, "hw": 32}, scale_keys={"n": 2.0, "c": 2.0}, round_to=4
        ),
        build=lambda n, c, hw: _make(n, c, hw),
    )
)
