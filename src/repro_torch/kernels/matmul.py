"""Blocked GEMM kernel (the GEMM and MaxFlops benchmarks, the DNN Connected
layer): C = A @ B with f32 accumulation, C in A's dtype.

Counterpart of ``repro/kernels/matmul.py``. The kernel is CUDA C++ for
Hopper in ``csrc/matmul.cu`` (see the note at its top for its bound and
design): a register-blocked f32 FMA GEMM that stays true f32, and a WMMA
bf16 tensor-core GEMM with f32 accumulators. It masks ragged edges itself
and reads each operand through its row and column strides, so a transposed
view is taken in place, never copied.

- :func:`matmul_cuda` launches the kernel. It takes CUDA tensors only and
  raises on anything it does not take: another device or dtype, a rank
  other than 2, mismatched shapes, or an operand with no unit stride.
- :func:`matmul_kernel` is the kernel route the dispatch layer calls: a CUDA
  tensor goes to :func:`matmul_cuda`, a CPU tensor to the plain version
  (:func:`matmul_plain`, the ``ref.py`` oracle), the way the reference runs
  its Pallas kernel interpreted off-TPU.
- ``launches`` counts launches of the kernel (``matmul_cuda`` only) per C
  entry point (f32, bf16); ``plain_calls`` counts kernel-route calls that
  ran the plain version because their tensors lay on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref as matmul_plain

__all__ = [
    "matmul_cuda",
    "matmul_kernel",
    "matmul_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"matmul_f32": 0, "matmul_bf16": 0}
plain_calls = 0

_DTYPES = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}
_TILE = {"block_m": 128, "block_n": 128}  # the one tile csrc compiles
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p,
]


def tune_space() -> tuple[dict, ...]:
    """Tile candidates (first entry = the kernel's defaults).

    The reference sweeps 128/256 blocks sized for the TPU's 128x128 matrix
    unit. On Hopper a block is one CTA: 128x128 (256 threads for f32, eight
    warps of WMMA fragments for bf16) fills the SMs at the suite's large
    shapes. It is the only tile compiled until a tune stage has a shape
    where another one wins.
    """
    return (dict(_TILE),)


def _strides(t: torch.Tensor, name: str) -> tuple[int, int]:
    rows, cols = t.shape
    rs, cs = t.stride()
    if cs == 1 or rs == 1 or rows == 1 or cols == 1:
        return rs, cs
    raise ValueError(
        f"matmul kernel takes row- or column-major operands; {name} has "
        f"shape {tuple(t.shape)} and strides {t.stride()}"
    )


def matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128, block_n: int = 128
) -> torch.Tensor:
    """Launch the CUDA kernel on ``a`` (M, K) and ``b`` (K, N)."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(
            f"matmul_cuda needs CUDA tensors, got {a.device} and {b.device}"
        )
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise ValueError(
            f"matmul kernel takes two float32 or two bfloat16 operands, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul kernel takes (M, K) @ (K, N), got {tuple(a.shape)} @ "
            f"{tuple(b.shape)}"
        )
    if {"block_m": block_m, "block_n": block_n} != _TILE:
        raise ValueError(
            f"no compiled tile ({block_m}, {block_n}); compiled: {_TILE}"
        )
    m, k = a.shape
    n = b.shape[1]
    sam, sak = _strides(a, "a")
    sbk, sbn = _strides(b, "b")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    name = _DTYPES[a.dtype]
    fn = _build.function(name, _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = fn(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        sam, sak, sbk, sbn, stream,
    )
    _build.check(status, name)
    launches[name] += 1
    return c


def matmul_kernel(a: torch.Tensor, b: torch.Tensor, **blocks) -> torch.Tensor:
    """The kernel route: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (the only case it runs)."""
    global plain_calls
    if a.device.type == "cpu" and b.device.type == "cpu":
        plain_calls += 1
        return matmul_plain(a, b)
    return matmul_cuda(a, b, **blocks)
