"""§V-B Cooperative Groups: SRAD's fused step against its split phases.

Counterpart of ``benchmarks/feat_coop_groups.py``. The paper's cooperative
kernel fuses SRAD's two phases around a grid-wide sync; so does the port's
``srad_fused_f32`` (one cooperative launch, the coefficient kept in shared
memory, one ``grid.sync()``). Split is ``srad_phase1_f32`` then
``srad_phase2_f32``, two launches with the coefficient through device
memory between them. Both go through ``ops.srad_step(..., fused=...)`` on the
kernel route; on the CPU the plain versions run.

Each row holds the two against each other and against the plain step
(``ops.srad_step(mode="ref")``) on the same image, bit for bit, and raises
if they differ.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.benchmarks.common import Row
from repro_torch.core.harness import time_fn
from repro_torch.kernels import ops

SIZES = (128, 256, 512, 1024)
ITERS, WARMUP = 5, 2  # the reference's


def rows(sizes: tuple[int, ...] = SIZES, *, device: str = "cuda") -> list[Row]:
    out: list[Row] = []
    fused = functools.partial(ops.srad_step, fused=True, mode="kernel")
    split = functools.partial(ops.srad_step, fused=False, mode="kernel")
    for n in sizes:
        rng = np.random.default_rng(0)
        img = torch.from_numpy(np.exp(0.1 * rng.standard_normal((n, n), dtype=np.float32)))
        img = img.to(device)
        want = ops.srad_step(img, mode="ref")
        for what, fn in (("fused", fused), ("split", split)):
            if not torch.equal(fn(img), want):
                raise AssertionError(
                    f"feat_cg {n}x{n}: the {what} step differs from the plain step")
        us_fused, _ = time_fn(fused, (img,), iters=ITERS, warmup=WARMUP, device=device)
        us_split, _ = time_fn(split, (img,), iters=ITERS, warmup=WARMUP, device=device)
        out.append(
            (
                f"feat_cg.srad.{n}x{n}",
                us_fused,
                f"fused_us={us_fused:.1f};split_us={us_split:.1f};"
                f"fused_speedup={us_split / max(us_fused, 1e-9):.2f}",
            )
        )
    return out
