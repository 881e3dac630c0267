"""Inclusive prefix-sum kernel (the substrate of the Where benchmark).

Counterpart of ``repro/kernels/prefix_scan.py``. The kernel is CUDA C++ for
Hopper in ``csrc/prefix_scan.cu`` (see the note at its top for its bound and
design): a single-pass scan with decoupled look-back, accumulated in f32.
The TPU kernel carries the running total from one block to the next in an
SMEM scalar, which relies on the TPU walking its grid in order; GPU blocks
run in no order, so each tile publishes its sum and its successors look back
for it instead.

- :func:`prefix_scan_cuda` launches the kernel on a 1-D contiguous float32
  CUDA tensor of any length, one tile of ``block_n`` = 2048 elements per
  block (the one tile the source compiles). It raises on another device,
  dtype, rank or layout, and on another ``block_n``.
- :func:`prefix_scan_kernel` is the kernel route: it refuses another
  ``block_n`` on either device, then CUDA tensors launch and CPU tensors run
  the plain version (:func:`prefix_scan_plain`, the ``ref.py`` oracle).
- ``launches`` and ``plain_calls`` count as in ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import prefix_scan_ref as prefix_scan_plain

__all__ = [
    "prefix_scan_cuda",
    "prefix_scan_kernel",
    "prefix_scan_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"prefix_scan_f32": 0}
plain_calls = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """Tile candidates under the reference's key (first entry = the kernel's
    defaults): the elements one block scans. It is the only tile compiled
    until a tune stage has a length where another one wins. A literal, so
    ``python -m repro_torch.check`` can read it."""
    return ({"block_n": 2048},)


BLOCK_N = tune_space()[0]["block_n"]  # the one tile csrc compiles: 256 threads x 8 elements


def _check_block(block_n: int) -> None:
    if block_n != BLOCK_N:
        raise ValueError(f"prefix_scan kernel: no compiled block_n {block_n}; "
                         f"compiled: {BLOCK_N}")


def prefix_scan_cuda(x: torch.Tensor, *, block_n: int = 2048) -> torch.Tensor:
    """Launch the CUDA kernel: the inclusive prefix sum of ``x`` (N,)."""
    if not x.is_cuda:
        raise ValueError(f"prefix_scan_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"prefix_scan kernel takes float32, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"prefix_scan kernel takes a 1-D tensor, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"prefix_scan kernel takes a contiguous tensor, got stride {x.stride()}")
    _check_block(block_n)
    n = x.numel()
    y = torch.empty_like(x)
    if n == 0:
        return y
    # One status word per tile, and the tile counter after them.
    scratch = torch.empty(-(-n // BLOCK_N) + 1, dtype=torch.int64, device=x.device)
    fn = _build.function("prefix_scan_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), y.data_ptr(), n, scratch.data_ptr(), stream)
    _build.check(status, "prefix_scan_f32")
    _build.count(launches, "prefix_scan_f32")
    return y


def prefix_scan_kernel(x: torch.Tensor, *, block_n: int = 2048) -> torch.Tensor:
    """The kernel route: a ``block_n`` other than the compiled tile is
    refused on either device; then the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor (the only case it runs)."""
    global plain_calls
    _check_block(block_n)
    if x.device.type == "cpu":
        plain_calls += 1
        return prefix_scan_plain(x)
    return prefix_scan_cuda(x, block_n=block_n)
