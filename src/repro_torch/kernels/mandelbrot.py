"""Mandelbrot kernels: the flat escape-time loop, and Mariani-Silver with
device-side launch (the paper's Dynamic Parallelism).

Counterpart of ``repro/bench/level2/mandelbrot.py::escape_time`` and
``::mariani_silver``, which have no TPU kernel: the reference imitates
Dynamic Parallelism by batching the mixed tiles through ``lax.map``. The
kernels are CUDA C++ for Hopper in ``csrc/mandelbrot.cu`` (see the note at
its top), built with relocatable device code and device-linked against the
device runtime (``kernels/_build.py``).

- :func:`mandelbrot_flat_cuda` launches ``mandelbrot_flat_i32``, one thread
  a pixel, on a square complex64 CUDA image.
- :func:`mandelbrot_dp_cuda` launches ``mandelbrot_dp_i32``: one parent CTA
  a 32x32 tile iterates the tile's border, fills an interior tile with
  ``max_iter`` and launches a child grid from the device over a mixed one.
  Each device-side launch reports into a :class:`DpStatus` (two int32 on the
  card: the first launch error and the child grids launched), which
  :meth:`DpStatus.check` reads and turns into an exception. Without a
  status the call makes its own and checks it before returning, which
  synchronizes; a timed caller passes one and checks it after timing.
- :func:`mandelbrot_flat_kernel` and :func:`mandelbrot_dp_kernel` are the
  kernel routes: CUDA tensors launch, CPU tensors run the plain versions
  (the benchmark module's ``escape_time`` and ``mariani_silver``).
- :func:`mixed_tiles_plain` counts the tiles whose border escapes, the child
  grids the adaptive kernel must launch.
- ``launches`` counts host launches per C entry point (a DP call is one,
  whatever its children); ``plain_calls`` counts as in ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.bench.level2.mandelbrot import TILE, _iterate, escape_time, mariani_silver
from repro_torch.kernels import _build

__all__ = [
    "DpStatus",
    "mandelbrot_flat_cuda",
    "mandelbrot_dp_cuda",
    "mandelbrot_flat_kernel",
    "mandelbrot_dp_kernel",
    "mixed_tiles_plain",
    "launches",
    "plain_calls",
]

launches = {"mandelbrot_flat_i32": 0, "mandelbrot_dp_i32": 0}
plain_calls = 0

_FLAT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_DP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]


class DpStatus:
    """What the device-side launches of ``mandelbrot_dp_i32`` report: the
    first launch error and the child grids launched, accumulated on the card
    over every call given this status."""

    def __init__(self, device: torch.device | str = "cuda") -> None:
        self.words = torch.zeros(2, dtype=torch.int32, device=device)

    def check(self) -> int:
        """Raise if a device-side launch failed; else the child grids
        launched so far. Reads the card, so it waits for the calls."""
        err, children = self.words.tolist()
        _build.check(err, "mandelbrot_dp_i32 (a child grid launched from the device)")
        return children


def _check_image(c: torch.Tensor, what: str) -> int:
    if not c.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {c.device}")
    if c.dtype != torch.complex64:
        raise ValueError(f"{what} takes complex64, got {c.dtype}")
    if c.dim() != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"{what} takes a square 2-D image, got shape {tuple(c.shape)}")
    if not c.is_contiguous():
        raise ValueError(f"{what} takes a contiguous image, got stride {c.stride()}")
    return c.shape[0]


def mandelbrot_flat_cuda(c: torch.Tensor, max_iter: int) -> torch.Tensor:
    """Escape-time counts (int32, n x n) of the image ``c``, one thread a pixel."""
    n = _check_image(c, "mandelbrot_flat_cuda")
    out = torch.empty(c.shape, dtype=torch.int32, device=c.device)
    if n == 0:
        return out
    fn = _build.function("mandelbrot_flat_i32", _FLAT_ARGS)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _build.check(fn(c.data_ptr(), out.data_ptr(), n, max_iter, stream), "mandelbrot_flat_i32")
    launches["mandelbrot_flat_i32"] += 1
    return out


def mandelbrot_dp_cuda(c: torch.Tensor, max_iter: int, *,
                       status: DpStatus | None = None) -> torch.Tensor:
    """Mariani-Silver counts (int32, n x n), n a multiple of 32: the border
    of each tile on the card, a child grid launched from the device for each
    mixed tile. Without ``status`` it checks its own before returning."""
    n = _check_image(c, "mandelbrot_dp_cuda")
    if n % TILE:
        raise ValueError(f"mandelbrot_dp_cuda: n = {n} is not a multiple of the tile {TILE}")
    own = status is None
    if own:
        status = DpStatus(c.device)
    out = torch.empty(c.shape, dtype=torch.int32, device=c.device)
    if n:
        fn = _build.function("mandelbrot_dp_i32", _DP_ARGS)
        stream = torch.cuda.current_stream(c.device).cuda_stream
        _build.check(fn(c.data_ptr(), out.data_ptr(), status.words.data_ptr(), n, max_iter,
                        stream), "mandelbrot_dp_i32")
        launches["mandelbrot_dp_i32"] += 1
    if own:
        status.check()
    return out


def mandelbrot_flat_kernel(c: torch.Tensor, max_iter: int) -> torch.Tensor:
    """The kernel route: the CUDA kernel for a CUDA image, the plain version
    (``escape_time``) for a CPU image."""
    global plain_calls
    if c.device.type == "cpu":
        plain_calls += 1
        return escape_time(c, max_iter)
    return mandelbrot_flat_cuda(c, max_iter)


def mandelbrot_dp_kernel(c: torch.Tensor, max_iter: int, *,
                         status: DpStatus | None = None) -> torch.Tensor:
    """The kernel route: device-side launch for a CUDA image, the plain
    version (``mariani_silver``) for a CPU image."""
    global plain_calls
    if c.device.type == "cpu":
        plain_calls += 1
        return mariani_silver(c, max_iter)
    return mandelbrot_dp_cuda(c, max_iter, status=status)


def mixed_tiles_plain(c: torch.Tensor, max_iter: int, tile: int = TILE) -> int:
    """Tiles whose border leaves the set within ``max_iter`` steps: the
    mixed tiles, as ``mariani_silver`` classifies them."""
    n = c.shape[0]
    t = n // tile
    tiles = c.reshape(t, tile, t, tile).transpose(1, 2).reshape(-1, tile, tile)
    border = torch.cat(
        [tiles[:, 0, :], tiles[:, -1, :], tiles[:, :, 0], tiles[:, :, -1]], dim=1
    )
    return int((~torch.all(_iterate(border, max_iter) == max_iter, dim=1)).sum())
