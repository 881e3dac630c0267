"""DNN: Batchnorm — training-mode batch normalisation forward and backward.

Counterpart of ``repro/bench/dnn/batchnorm.py``: NCHW statistics over
(N, H, W) per channel, in plain PyTorch (no kernel, as in the reference).
``jnp.var`` is the population variance, so the port asks for
``correction=0``; torch's default, the unbiased variance, would differ by a
factor N·H·W / (N·H·W − 1).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register

EPS = 1e-5


def batchnorm_train(x, gamma, beta):
    """NCHW batch norm over (N, H, W) per channel."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), correction=0, keepdim=True)
    xhat = (x - mean) * torch.rsqrt(var + EPS)
    return xhat * gamma[None, :, None, None] + beta[None, :, None, None]


def _make(n: int, c: int, hw: int):
    shape = (n, c, hw, hw)

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(shape, dtype=np.float32)
        gamma = np.float32(1.0) + np.float32(0.1) * rng.standard_normal(c, dtype=np.float32)
        beta = np.float32(0.1) * rng.standard_normal(c, dtype=np.float32)
        return tuple(torch.from_numpy(a) for a in (x, gamma, beta))

    def validate(out, args):
        # Normalised-then-affine: per channel, mean ~ beta and std ~ |gamma|.
        # The statistics are taken in f64 on the output's device.
        _, gamma, beta = (a.double() for a in args)
        o = out.double()
        torch.testing.assert_close(o.mean(dim=(0, 2, 3)), beta, rtol=0.0, atol=1e-4)
        torch.testing.assert_close(
            o.std(dim=(0, 2, 3), correction=0), gamma.abs(), rtol=1e-3, atol=1e-4
        )

    numel = float(n * c * hw * hw)
    return dnn_workload(
        f"batchnorm.{n}x{c}x{hw}x{hw}",
        batchnorm_train,
        make_inputs,
        flops=numel * 8,
        bytes_moved=numel * 4 * 3,
        validate=validate,
        diff_argnums=(0, 1, 2),
        batch_dims=(0, None, None),
    )


register(
    BenchmarkSpec(
        name="batchnorm",
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
