"""Level 2: Mandelbrot — the Dynamic-Parallelism benchmark.

Counterpart of ``repro/bench/level2/mandelbrot.py``, the paper's pair:

- ``escape_time``: every pixel iterates z ← z² + c until |z| > 2 or
  ``max_iter`` (the baseline without Dynamic Parallelism);
- ``mariani_silver``: the adaptive algorithm. The image is cut into
  32×32 tiles; one border pass iterates the four edges of every tile
  together; a tile whose border never escaped is filled with
  ``max_iter`` without iterating, and the remaining (mixed) tiles iterate
  together as one batch. Device-side launch is not ported yet.

The iteration runs on the real and imaginary parts as f32 tensors, one
rounded operation at a time (real = zr·zr − zi·zi + cr, imag = zr·zi +
zi·zr + ci, |z| by ``hypot``), so a pixel's arithmetic does not depend on
the shape of the batch it is in and both algorithms give equal counts.

The reference's ``while_loop`` ends when no pixel is active, a
data-dependent trip count. Here it is a host-checked loop: one scalar read
of "any pixel still active" every :data:`CHECK_EVERY` steps, all else on
the device. An escaped pixel is frozen, so steps past the last escape
change nothing and the counts equal those of a check every step. The
adaptive version reads one more thing on the host: which tiles are mixed
(one ``nonzero``). Under ``torch.vmap`` (the serve stage's width-w call)
both run over the members' images at once (``core/hostloop.py``): the
check sees every member, and the mixed tiles of all of them iterate as
one batch. On a sharded image (a DTensor, ``runtime/sharding.py``) the
flat version runs each rank's rows through its own host-checked loop
(``ops.sharded``: pixels are independent, and a frozen pixel's count does
not depend on when its loop stops).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.hostloop import rows_call
from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register
from repro_torch.kernels.ops import shard_dim, sharded

CHECK_EVERY = 32
TILE = 32


def pixel_grid(n: int, center=(-0.6, 0.0), extent=2.6) -> torch.Tensor:
    """The fixed view, complex64 (n, n): rows are the imaginary axis."""
    xs = np.linspace(center[0] - extent / 2, center[0] + extent / 2, n, dtype=np.float32)
    ys = np.linspace(center[1] - extent / 2, center[1] + extent / 2, n, dtype=np.float32)
    return torch.complex(torch.from_numpy(xs)[None, :].expand(n, n),
                         torch.from_numpy(ys)[:, None].expand(n, n))


def _iterate(c: torch.Tensor, max_iter: int) -> torch.Tensor:
    """Escape-time counts (int32) for a complex block of any shape."""
    cr, ci = c.real.contiguous(), c.imag.contiguous()
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    n = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
    k = 0
    while k < max_iter:
        for _ in range(min(CHECK_EVERY, max_iter - k)):
            active = torch.hypot(zr, zi) <= 2.0
            re = zr * zr - zi * zi + cr
            im = zr * zi + zi * zr + ci
            zr = torch.where(active, re, zr)
            zi = torch.where(active, im, zi)
            n += active
        k += CHECK_EVERY
        if not bool((torch.hypot(zr, zi) <= 2.0).any()):  # the host check
            break
    return n


@sharded("escape_time", lambda c, *_, **__: shard_dim(c))
def escape_time(c: torch.Tensor, max_iter: int) -> torch.Tensor:
    return rows_call(functools.partial(_iterate, max_iter=max_iter), c)


def _mariani_silver_rows(c: torch.Tensor, max_iter: int, tile: int) -> torch.Tensor:
    """Mariani-Silver over images (W, n, n): every image's tile borders in
    one batch, then every mixed tile of every image in one batch."""
    w, n = c.shape[0], c.shape[1]
    assert n % tile == 0
    t = n // tile
    tiles = c.reshape(w, t, tile, t, tile).transpose(2, 3).reshape(-1, tile, tile)
    border = torch.cat(
        [tiles[:, 0, :], tiles[:, -1, :], tiles[:, :, 0], tiles[:, :, -1]], dim=1
    )
    interior = torch.all(_iterate(border, max_iter) == max_iter, dim=1)
    out = torch.full((w * t * t, tile, tile), max_iter, dtype=torch.int32, device=c.device)
    mixed = torch.nonzero(~interior).flatten()  # the tiles that iterate
    if mixed.numel():
        out[mixed] = _iterate(tiles[mixed], max_iter)
    return out.reshape(w, t, t, tile, tile).transpose(2, 3).reshape(w, n, n)


def mariani_silver(c: torch.Tensor, max_iter: int, tile: int = TILE) -> torch.Tensor:
    return rows_call(functools.partial(_mariani_silver_rows, max_iter=max_iter, tile=tile), c)


def _make(n: int, max_iter: int, adaptive: bool) -> Workload:
    def make_inputs(seed: int):
        del seed  # the view is fixed, as the reference's
        return (pixel_grid(n),)

    fn = (
        functools.partial(mariani_silver, max_iter=max_iter)
        if adaptive
        else functools.partial(escape_time, max_iter=max_iter)
    )

    def validate(out, args):
        (c,) = args
        assert torch.equal(out, escape_time(c, max_iter)), "the two algorithms disagree"

    return Workload(
        name=f"mandelbrot.{'ms' if adaptive else 'flat'}.{n}px.i{max_iter}",
        fn=fn,
        make_inputs=make_inputs,
        flops=float(n * n * max_iter * 10),  # upper bound (flat version)
        bytes_moved=float(n * n * 12),
        validate=validate,
        # As the reference: flat shards image rows; the tiling opts out.
        batch_dims=None if adaptive else (0,),
    )


for _adaptive in (False, True):
    register(
        BenchmarkSpec(
            name=f"mandelbrot_{'ms' if _adaptive else 'flat'}",
            level=2,
            dwarf=None,
            domain="Numerical analysis",
            cuda_feature="Dynamic Parallelism" if _adaptive else None,
            gpu_feature="tile-adaptive refinement, mixed tiles in one batch"
            if _adaptive
            else None,
            presets=geometric_presets(
                {"n": 128, "max_iter": 64, "adaptive": _adaptive},
                scale_keys={"n": 2.0, "max_iter": 2.0},
                round_to=32,
            ),
            build=lambda n, max_iter, adaptive: _make(n, max_iter, adaptive),
        )
    )
