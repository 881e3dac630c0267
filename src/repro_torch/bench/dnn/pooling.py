"""DNN: Pooling — average pooling forward and backward (paper: cuDNN avg pool).

Counterpart of ``repro/bench/dnn/pooling.py``. The forward pass runs the
hand-written average-pool kernel (``--impl kernel``) or the plain PyTorch
oracle; the backward pass spreads each output's gradient evenly over its
window (grad / ksize²), through autograd of the oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register
from repro_torch.kernels import ops, ref


def _make(n: int, c: int, hw: int, ksize: int):
    shape = (n, c, hw, hw)

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),)

    def fn(x):
        return ops.avgpool(x, ksize=ksize)

    def validate(out, args):
        # The reference's validate has rtol 1e-5 and no absolute term. A
        # kernel that adds a window's ksize² values in another order than
        # torch's mean differs from it in the last bit, which is a large
        # relative error on an output near zero (on an H100 at preset 4:
        # 8.9e-8 absolute, 0.17 relative, at 0.1% of the outputs). The
        # absolute term is the reference's own avgpool kernel test's, 1e-6
        # (tests/test_kernels_misc.py:43).
        (x,) = args
        torch.testing.assert_close(
            out, ref.avgpool_ref(x, ksize=ksize), rtol=1e-5, atol=1e-6
        )

    numel = float(n * c * hw * hw)
    return dnn_workload(
        f"pooling.avg{ksize}.{n}x{c}x{hw}x{hw}",
        fn,
        make_inputs,
        flops=numel,
        bytes_moved=numel * 4 * (1 + 1 / ksize**2),
        validate=validate,
        diff_argnums=(0,),
        batch_dims=(0,),
        kernel="avgpool",
    )


register(
    BenchmarkSpec(
        name="pooling",
        level=2,
        dwarf="Dense linear algebra",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature="one thread per output, float2 row loads (CUDA)",
        presets=geometric_presets(
            {"n": 8, "c": 16, "hw": 32, "ksize": 2},
            scale_keys={"n": 2.0, "c": 2.0},
            round_to=4,
        ),
        build=lambda n, c, hw, ksize: _make(n, c, hw, ksize),
    )
)
