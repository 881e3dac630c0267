"""Average-pooling kernel (the DNN Pooling benchmark; stride == window).

Counterpart of ``repro/kernels/avgpool.py``. The kernel is CUDA C++ for
Hopper in ``csrc/avgpool.cu`` (see the note at its top for its bound and
design): one thread per output element, the window summed in f32, the two
rows of a 2x2 window read as one ``float2`` each. The TPU kernel's channel
blocking and padding are not carried over: a grid over outputs needs none.

- :func:`avgpool_cuda` launches the kernel on a contiguous (N, C, H, W)
  float32 CUDA tensor. It raises on another device, dtype, rank or layout,
  and on H or W not divisible by ``ksize`` (see :func:`avgpool_kernel`).
- :func:`avgpool_kernel` is the kernel route: it refuses H or W not
  divisible by ``ksize`` on either device, then CUDA tensors launch and CPU
  tensors run the plain version (:func:`avgpool_plain`, the ``ref.py``
  oracle).
- ``launches`` and ``plain_calls`` count as in ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import avgpool_ref as avgpool_plain

__all__ = [
    "avgpool_cuda",
    "avgpool_kernel",
    "avgpool_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"avgpool_f32": 0}
plain_calls = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """No block parameters: the reference blocks channels to fit VMEM, while
    here one thread owns one output (single entry)."""
    return ({},)


def _check_window(x: torch.Tensor, ksize: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"avgpool kernel takes (N, C, H, W), got shape {tuple(x.shape)}")
    h, w = x.shape[2:]
    if ksize < 1 or h % ksize or w % ksize:
        raise ValueError(
            f"avgpool kernel needs H={h} and W={w} divisible by ksize={ksize}"
        )


def avgpool_cuda(x: torch.Tensor, *, ksize: int = 2) -> torch.Tensor:
    """Launch the CUDA kernel: ``ksize`` x ``ksize`` means of ``x``, stride
    ``ksize``."""
    if not x.is_cuda:
        raise ValueError(f"avgpool_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"avgpool kernel takes float32, got {x.dtype}")
    _check_window(x, ksize)
    if not x.is_contiguous():
        raise ValueError(
            f"avgpool kernel takes a contiguous NCHW tensor, got strides {x.stride()}"
        )
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // ksize, w // ksize), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _build.function("avgpool_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), y.data_ptr(), n * c, h, w, ksize, stream)
    _build.check(status, "avgpool_f32")
    _build.count(launches, "avgpool_f32")
    return y


def avgpool_kernel(x: torch.Tensor, *, ksize: int = 2) -> torch.Tensor:
    """The kernel route: a window that does not tile H and W is refused on
    either device; then the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor (the only case it runs)."""
    global plain_calls
    _check_window(x, ksize)
    if x.device.type == "cpu":
        plain_calls += 1
        return avgpool_plain(x, ksize=ksize)
    return avgpool_cuda(x, ksize=ksize)
