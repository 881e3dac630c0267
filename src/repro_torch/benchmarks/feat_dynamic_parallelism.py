"""§V-B Dynamic Parallelism: Mandelbrot escape-time against Mariani-Silver
adaptive tiles with device-side launch.

Counterpart of ``benchmarks/feat_dynamic_parallelism.py``. The paper's
cleanest feature win: the adaptive algorithm skips interior swaths, more of
them the larger the image. Both sides are hand-written kernels
(``kernels/mandelbrot.py``): ``mandelbrot_flat_i32``, one thread a pixel,
and ``mandelbrot_dp_i32``, one parent CTA a 32x32 tile that fills an
interior tile and launches a child grid from the device over a mixed one.
On the CPU the plain versions run (``escape_time``, ``mariani_silver``).

Each row checks that the two images are equal and that the adaptive kernel
launched one child grid a mixed tile in every call (``mixed_tiles``, the
plain classification's count), and raises otherwise.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.bench.level2.mandelbrot import pixel_grid
from repro_torch.benchmarks.common import Row
from repro_torch.core.harness import time_fn
from repro_torch.kernels import mandelbrot

SIZES = (128, 256, 512)
MAX_ITER = 256
ITERS, WARMUP = 3, 1  # the reference's


def rows(max_iter: int = MAX_ITER, *, sizes: tuple[int, ...] = SIZES,
         device: str = "cuda") -> list[Row]:
    out: list[Row] = []
    cuda = torch.device(device).type == "cuda"
    for n in sizes:
        c = pixel_grid(n).to(device)
        status = mandelbrot.DpStatus(device) if cuda else None
        flat = functools.partial(mandelbrot.mandelbrot_flat_kernel, max_iter=max_iter)
        adap = functools.partial(mandelbrot.mandelbrot_dp_kernel, max_iter=max_iter,
                                 status=status)
        if not torch.equal(flat(c), adap(c)):
            raise AssertionError(f"feat_dp {n}px: flat and adaptive counts differ")
        us_flat, _ = time_fn(flat, (c,), iters=ITERS, warmup=WARMUP, device=device)
        us_adap, _ = time_fn(adap, (c,), iters=ITERS, warmup=WARMUP, device=device)
        mixed = mandelbrot.mixed_tiles_plain(c, max_iter)
        if cuda:
            calls = 1 + ITERS + WARMUP
            children = status.check()
            if children != mixed * calls:
                raise AssertionError(f"feat_dp {n}px: {children} child grids in {calls} calls, "
                                     f"expected {mixed} mixed tiles a call")
        out.append(
            (
                f"feat_dp.mandelbrot.{n}px",
                us_adap,
                f"flat_us={us_flat:.1f};adaptive_us={us_adap:.1f};"
                f"speedup={us_flat / max(us_adap, 1e-9):.2f};mixed_tiles={mixed}",
            )
        )
    return out
