"""Level 0: DeviceMemory — device memory-hierarchy bandwidth.

Counterpart of ``repro/bench/level0/devicemem.py``. The paper measures
global, constant and shared memory; the reference exposes three streams
and the port keeps them:

- ``stream``: y = a·x + y over N elements, one ``torch.add`` with
  ``alpha`` (HBM-bound, 3 N·4 bytes);
- ``reduce``: ``torch.sum(x)`` (HBM read-bound, N·4 bytes);
- ``vmem``: a 128×128 tile (64 KB) sliced from x, iterated 64 times as
  ``t * 0.999 + 0.001`` (the reference's ``fori_loop``; reported bytes
  count only the tile's load and store). On the card the 64 steps, two
  elementwise launches each, are one CUDA graph replay a call
  (:data:`GRAPHS`), so the row measures 128 back-to-back elementwise passes
  over a tile that stays in L2, with no launch from the host between them.
  It is not a shared-memory number: no kernel here holds the tile in
  shared memory. Eagerly it would time 128 host launches instead.

The reference has no check for these rows; ``validate`` holds each to an
f64 evaluation of the same inputs (the sum within 1e-6·Σ|x|, the others
within 1e-5 of the output's largest magnitude).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graphs import GraphCache
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register

TILE, STEPS = 128, 64
GRAPHS = GraphCache()


def vmem_steps(x: torch.Tensor) -> torch.Tensor:
    """The 64 steps on the first 128×128 elements of ``x``, eagerly."""
    tile = x[: TILE * TILE].reshape(TILE, TILE)
    for _ in range(STEPS):
        tile = tile * 0.999 + 0.001
    return tile


def _inputs(n: int):
    def make_inputs(seed: int):
        rng = np.random.default_rng(seed)
        return (
            torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
            torch.from_numpy(rng.standard_normal(n, dtype=np.float32)),
        )

    return make_inputs


def _make(n: int, op: str) -> Workload:
    if op == "stream":

        def fn(x, y):
            return torch.add(y, x, alpha=1.0001)

        flops, nbytes = 2.0 * n, 12.0 * n
    elif op == "reduce":

        def fn(x, y):
            return torch.sum(x)

        flops, nbytes = float(n), 4.0 * n
    elif op == "vmem":

        def fn(x, y):
            return GRAPHS.run(vmem_steps, x)

        flops, nbytes = 2.0 * TILE * TILE * STEPS, 4.0 * TILE * TILE * 2
    else:
        raise ValueError(op)

    def validate(out, args):
        x, y = (a.double() for a in args)
        want = vmem_steps(x) if op == "vmem" else fn(x, y)
        tol = 1e-6 * float(x.abs().sum()) if op == "reduce" else 1e-5 * float(want.abs().max())
        assert float((out.double() - want).abs().max()) <= tol, f"devicemem.{op} is off"

    return Workload(
        name=f"devicemem.{op}.n{n}",
        fn=fn,
        make_inputs=_inputs(n),
        flops=flops,
        bytes_moved=nbytes,
        validate=validate,
        # As the reference: stream and reduce are data-parallel over the
        # element dim; vmem is one tile sliced from x.
        batch_dims=(0, 0) if op in ("stream", "reduce") else None,
    )


for _op in ("stream", "reduce", "vmem"):
    register(
        BenchmarkSpec(
            name=f"devicemem_{_op}",
            level=0,
            dwarf=None,
            domain=None,
            cuda_feature=None,
            gpu_feature={
                "stream": "HBM stream (one torch.add)",
                "reduce": "HBM read reduction (torch.sum)",
                "vmem": "L2-resident elementwise passes, one CUDA graph replay",
            }[_op],
            presets=geometric_presets(
                {"n": 1 << 16, "op": _op}, scale_keys={"n": 8.0}, round_to=128
            ),
            build=lambda n, op: _make(n, op),
        )
    )
