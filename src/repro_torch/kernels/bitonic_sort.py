"""Key-value sort kernel (the Sort benchmark). The kernel is a radix sort.

Counterpart of ``repro/kernels/bitonic_sort.py``, whose name it keeps so
that the port follows the reference path for path. The reference sorts
with a bitonic network because radix sort's histogram-and-scatter loop is
gather- and scatter-bound, which the TPU's vector unit punishes; a bitonic
network needs none, at O(n log^2 n) work, in one VMEM block of a
power-of-two length. Hopper scatters well, and one block cannot hold the
Sort benchmark's 2^24 keys, so the kernel here is the paper's own LSD radix
sort (Satish et al.): CUDA C++ in ``csrc/radix_sort.cu`` (see the note at
its top for its bound and design), 8-bit digits, four passes between
ping-pong buffers, any length, no padding.

Radix sort is stable, so it equals the stable plain version
(:func:`sort_kv_plain`, ``torch.sort(stable=True)`` and a gather) to the
bit, keys and values; the reference's bitonic kernel is not stable (equal
keys keep their own values, in some order).

- :func:`sort_kv_cuda` launches the kernel on 1-D contiguous CUDA keys
  (int32 or float32) and values (any 4-byte dtype) of one length below
  2^31. It raises on another device, dtype, rank, layout or length.
- :func:`sort_kv_kernel` is the kernel route: CUDA tensors launch, CPU
  tensors run the plain version.
- ``launches`` counts one launch per sort (the C entry point runs the four
  passes), per key dtype; ``plain_calls`` counts as in ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sort_kv_ref as sort_kv_plain

__all__ = [
    "sort_kv_cuda",
    "sort_kv_kernel",
    "sort_kv_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"sort_kv_i32": 0, "sort_kv_f32": 0}
plain_calls = 0

_KEYS = {torch.int32: "sort_kv_i32", torch.float32: "sort_kv_f32"}
RADIX = 256  # 8-bit digits
MAX_N = 2**31 - 1
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """No block parameters (single entry): a tile is 4096 keys, 16 for each
    of 256 threads, one thread per digit value where a block works per
    digit."""
    return ({},)


def sort_kv_cuda(keys: torch.Tensor, values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``keys`` in ascending order, stable, each
    carrying its value."""
    if not (keys.is_cuda and values.is_cuda):
        raise ValueError(
            f"sort_kv_cuda needs CUDA tensors, got {keys.device} and {values.device}"
        )
    if keys.dtype not in _KEYS:
        raise ValueError(f"sort_kv kernel takes int32 or float32 keys, got {keys.dtype}")
    if values.element_size() != 4:
        raise ValueError(f"sort_kv kernel takes 4-byte values, got {values.dtype}")
    if keys.dim() != 1 or values.shape != keys.shape or values.device != keys.device:
        raise ValueError(
            f"sort_kv kernel takes 1-D keys and values of one length on one device, got "
            f"{tuple(keys.shape)} on {keys.device} and {tuple(values.shape)} on {values.device}"
        )
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("sort_kv kernel takes contiguous keys and values")
    n = keys.numel()
    if n > MAX_N:
        raise ValueError(f"sort_kv kernel takes at most {MAX_N} keys, got {n}")
    keys_out, values_out = torch.empty_like(keys), torch.empty_like(values)
    if n == 0:
        return keys_out, values_out
    name = _KEYS[keys.dtype]
    fn = _build.function(name, _ARGTYPES)
    tile = _build.function("radix_sort_tile", [])()  # keys per tile in csrc
    # Ping-pong buffers for the odd passes, the (digit x tile) counts and
    # the per-digit totals.
    tmp_keys, tmp_values = torch.empty_like(keys), torch.empty_like(values)
    counts = torch.empty(RADIX * -(-n // tile), dtype=torch.int32, device=keys.device)
    totals = torch.empty(RADIX, dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    status = fn(keys.data_ptr(), values.data_ptr(), keys_out.data_ptr(), values_out.data_ptr(),
                tmp_keys.data_ptr(), tmp_values.data_ptr(), counts.data_ptr(),
                totals.data_ptr(), n, stream)
    _build.check(status, name)
    launches[name] += 1
    return keys_out, values_out


def sort_kv_kernel(keys: torch.Tensor, values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel route: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (the only case it runs)."""
    global plain_calls
    if keys.device.type == "cpu":
        plain_calls += 1
        return sort_kv_plain(keys, values)
    return sort_kv_cuda(keys, values)
