"""Cross-channel LRN kernel (the DNN LRN benchmark, paper eq. 3).

Counterpart of ``repro/kernels/lrn.py``. The kernel is CUDA C++ for Hopper
in ``csrc/lrn.cu`` (see the note at its top for its bound and design): each
output sums its own window of ``size`` squares over the channels, in the
oracle's order, with threads on neighbouring spatial positions and the
channels split into chunks of 32 per block. The TPU kernel's band-matrix
product on the MXU is not carried over.

- :func:`lrn_cuda` launches the kernel on a contiguous (N, C, H, W) float32
  CUDA tensor. It raises on another device, dtype, rank or layout, on an
  even ``size`` (see :func:`lrn_kernel`), on a ``size`` above 65 (the
  shared-memory tile's limit) and on more images or channel chunks than
  the grid holds (65535 each).
- :func:`lrn_kernel` is the kernel route: it refuses an even ``size`` on
  either device, then CUDA tensors launch and CPU tensors run the plain
  version (:func:`lrn_plain`, the ``ref.py`` oracle).
- ``launches`` and ``plain_calls`` count as in ``kernels/matmul.py``.

An even ``size`` is refused because the reference disagrees with itself
there: its TPU kernel's band covers ``size + 1`` channels (``|i - j| <=
size // 2``) while its oracle sums ``size`` channels starting at
``c - size // 2``. Its tests use sizes 3 and 5 only.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lrn_ref as lrn_plain

__all__ = [
    "lrn_cuda",
    "lrn_kernel",
    "lrn_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"lrn_f32": 0}
plain_calls = 0

MAX_SIZE = 65  # the channel tile (32 + size - 1 rows of 128) fits 48 KB
MAX_N = 65535  # the grid's z extent (images)
MAX_C = 65535 * 32  # the grid's y extent (chunks of 32 channels)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """No block parameters (single entry): the reference sweeps ``block_s``
    (spatial positions per grid step), while here a block is 128 spatial
    positions, one per thread, by 32 output channels, which at the DNN
    presets' 16x16 images makes thousands of blocks."""
    return ({},)


def _check_size(size: int) -> None:
    if size < 1 or size % 2 == 0:
        raise ValueError(
            f"lrn kernel takes an odd window size, got {size}: for an even size "
            "the reference's kernel sums size+1 channels and its oracle size"
        )


def lrn_cuda(
    x: torch.Tensor,
    *,
    size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    k: float = 2.0,
) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` (N, C, H, W), float32."""
    if not x.is_cuda:
        raise ValueError(f"lrn_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"lrn kernel takes float32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"lrn kernel takes (N, C, H, W), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"lrn kernel takes a contiguous NCHW tensor, got strides {x.stride()}"
        )
    _check_size(size)
    if size > MAX_SIZE:
        raise ValueError(f"lrn kernel takes size <= {MAX_SIZE}, got {size}")
    n, c, h, w = x.shape
    if n > MAX_N or c > MAX_C:
        raise ValueError(
            f"lrn kernel takes at most {MAX_N} images and {MAX_C} channels, got {n} and {c}"
        )
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _build.function("lrn_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), y.data_ptr(), n, c, h * w, size // 2,
                alpha, beta, k, stream)
    _build.check(status, "lrn_f32")
    launches["lrn_f32"] += 1
    return y


def lrn_kernel(
    x: torch.Tensor,
    *,
    size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    k: float = 2.0,
) -> torch.Tensor:
    """The kernel route: an even ``size`` is refused on either device; then
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor
    (the only case it runs)."""
    global plain_calls
    _check_size(size)
    if x.device.type == "cpu":
        plain_calls += 1
        return lrn_plain(x, size=size, alpha=alpha, beta=beta, k=k)
    return lrn_cuda(x, size=size, alpha=alpha, beta=beta, k=k)
