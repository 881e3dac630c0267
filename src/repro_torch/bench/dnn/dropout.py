"""DNN: Dropout — stochastic regularisation forward and backward (paper:
dropout_fp/bp).

Counterpart of ``repro/bench/dnn/dropout.py``. The reference draws its mask
from a threefry key passed as an argument; torch's Philox cannot give those
bits, so the port takes a Python int, ``mask_seed``, in the key's place.
Every call seeds a ``torch.Generator`` on the input's device with it, so
every call draws the same mask, as the reference's fixed key does. The
mask keeps ``rand >= RATE`` and the kept values are scaled by
``1 / (1 - RATE)``. There is no kernel: ``--impl kernel`` rows time torch.
Tests and ``validate`` hold it by its statistics, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench.dnn.common import dnn_workload
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import DNN_DOMAIN, BenchmarkSpec, register

RATE = 0.5


def dropout(x, mask_seed: int):
    gen = torch.Generator(device=x.device)
    gen.manual_seed(mask_seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= RATE
    return torch.where(keep, x / (1.0 - RATE), 0.0)


def _make(n: int, d: int):
    shape = (n, d)

    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(shape, dtype=np.float32)
        return (torch.from_numpy(x), int(rng.integers(0, 2**62)))

    def validate(out, args):
        # On the output's device: at preset 4 the input is 4 GiB.
        x, _ = args
        kept = out != 0
        frac = kept.double().mean().item()
        assert abs(frac - (1 - RATE)) < 0.05, f"keep fraction {frac}"
        torch.testing.assert_close(out[kept], x[kept] / (1 - RATE), rtol=1e-6, atol=0.0)

    numel = float(n * d)
    return dnn_workload(
        f"dropout.{n}x{d}",
        dropout,
        make_inputs,
        flops=numel * 2,
        bytes_moved=numel * 8,
        validate=validate,
        diff_argnums=(0,),
        batch_dims=(0, None),
    )


register(
    BenchmarkSpec(
        name="dropout",
        level=2,
        dwarf="Unstructured Grid",
        domain=DNN_DOMAIN,
        cuda_feature=None,
        gpu_feature="Philox mask from a per-call seeded generator (torch)",
        presets=geometric_presets(
            {"n": 256, "d": 1024}, scale_keys={"n": 4.0, "d": 2.0}, round_to=64
        ),
        build=lambda n, d: _make(n, d),
    )
)
