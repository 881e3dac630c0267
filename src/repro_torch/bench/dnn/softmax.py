"""DNN: Softmax — classifier output layer forward and backward (paper eq. 2).

Counterpart of ``repro/bench/dnn/softmax.py``, on the hand-written
row-softmax kernel (``--impl kernel``) or the plain PyTorch path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register
from repro_torch.kernels import ops


def _make(batch: int, classes: int):
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((batch, classes), dtype=np.float32)
        x *= np.float32(5.0)
        return (torch.from_numpy(x),)

    def fn(x):
        return ops.softmax(x)

    def validate(out, args):
        o = out.cpu().numpy()
        np.testing.assert_allclose(o.sum(-1), 1.0, rtol=1e-5)
        assert np.all(o >= 0)

    numel = float(batch * classes)
    return dnn_workload(
        f"softmax.{batch}x{classes}",
        fn,
        make_inputs,
        flops=numel * 5,
        bytes_moved=numel * 8,
        validate=validate,
        diff_argnums=(0,),
        batch_dims=(0,),
        kernel="softmax",
    )


register(
    BenchmarkSpec(
        name="softmax",
        level=2,
        dwarf="Unstructured Grid",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature="one-block-per-row online softmax (CUDA)",
        presets=geometric_presets(
            {"batch": 128, "classes": 1024},
            scale_keys={"batch": 4.0, "classes": 2.0},
            round_to=64,
        ),
        build=lambda batch, classes: _make(batch, classes),
    )
)
