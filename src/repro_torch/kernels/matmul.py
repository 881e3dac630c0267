"""Blocked GEMM kernel (the GEMM and MaxFlops benchmarks, the DNN Connected
layer, Convolution's im2col path): C = A @ B with f32 accumulation, C in A's
dtype.

Counterpart of ``repro/kernels/matmul.py``. The kernel is CUDA C++ for
Hopper in ``csrc/matmul.cu`` (see the note at its top for its bound and
design): a register-blocked f32 FMA GEMM that stays true f32, and a WMMA
bf16 tensor-core GEMM with f32 accumulators. It masks ragged edges itself
and reads each operand through its row and column strides, so a transposed
view is taken in place, never copied. A third grid axis runs a batch of
products in one launch, each operand offset by its own batch stride; a
stride of 0 broadcasts an operand, such as Convolution's shared weight.

- :func:`matmul_cuda` launches the kernel on ``a`` (M, K) or (B, M, K) and
  ``b`` (K, N) or (B, K, N), with ``torch.matmul``'s broadcasting of a
  2-D operand or a batch of 1. It takes CUDA tensors only and raises on
  anything it does not take: another device or dtype, a rank other than 2
  or 3, mismatched shapes or batches, more than 65535 batch entries, or an
  operand with no unit stride.
- :func:`matmul_kernel` is the kernel route the dispatch layer calls: a CUDA
  tensor goes to :func:`matmul_cuda`, a CPU tensor to the plain version
  (:func:`matmul_plain`, the ``ref.py`` oracle), the way the reference runs
  its Pallas kernel interpreted off-TPU.
- ``launches`` counts launches of the kernel (``matmul_cuda`` only) per C
  entry point (f32, bf16), batched launches (a 3-D result) under their own
  ``*_batched`` key; ``plain_calls`` counts kernel-route calls that ran the
  plain version because their tensors lay on the CPU.
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

launches = {
    "matmul_f32": 0, "matmul_bf16": 0, "matmul_f32_batched": 0, "matmul_bf16_batched": 0,
}
plain_calls = 0

_DTYPES = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}
_TILE = {"block_m": 128, "block_n": 128}  # the one tile csrc compiles
MAX_BATCH = 65535  # the grid's z extent
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
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
    rows, cols = t.shape[-2:]
    rs, cs = t.stride()[-2:]
    if cs == 1 or rs == 1 or rows == 1 or cols == 1:
        return rs, cs
    raise ValueError(
        f"matmul kernel takes row- or column-major operands; {name} has "
        f"shape {tuple(t.shape)} and strides {t.stride()}"
    )


def _batch_stride(t: torch.Tensor) -> int:
    """The stride between batch entries; 0 broadcasts (2-D, or a batch of 1)."""
    return t.stride(0) if t.dim() == 3 and t.shape[0] > 1 else 0


def matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, block_m: int = 128, block_n: int = 128
) -> torch.Tensor:
    """Launch the CUDA kernel on ``a`` (M, K) or (B, M, K) and ``b`` (K, N)
    or (B, K, N); the result is (B, M, N) when either operand is batched."""
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
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f"matmul kernel takes (M, K) or (B, M, K) @ (K, N) or (B, K, N), got "
            f"{tuple(a.shape)} @ {tuple(b.shape)}"
        )
    batches = {t.shape[0] for t in (a, b) if t.dim() == 3}
    if len(batches - {1}) > 1:
        raise ValueError(
            f"matmul kernel batches differ: {tuple(a.shape)} @ {tuple(b.shape)}"
        )
    batched = bool(batches)
    batch = max(batches, default=1)
    if batch > MAX_BATCH:
        raise ValueError(
            f"matmul kernel takes at most {MAX_BATCH} batch entries, got {batch}"
        )
    if {"block_m": block_m, "block_n": block_n} != _TILE:
        raise ValueError(
            f"no compiled tile ({block_m}, {block_n}); compiled: {_TILE}"
        )
    m, k = a.shape[-2:]
    n = b.shape[-1]
    sam, sak = _strides(a, "a")
    sbk, sbn = _strides(b, "b")
    c = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    if not batched:
        c = c[0]
    if batch == 0 or m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    name = _DTYPES[a.dtype]
    fn = _build.function(name, _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = fn(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k,
        _batch_stride(a), sam, sak, _batch_stride(b), sbk, sbn, stream,
    )
    _build.check(status, name)
    launches[name + "_batched" if batched else name] += 1
    return c


def matmul_kernel(a: torch.Tensor, b: torch.Tensor, **blocks) -> torch.Tensor:
    """The kernel route: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (the only case it runs)."""
    global plain_calls
    if a.device.type == "cpu" and b.device.type == "cpu":
        plain_calls += 1
        return matmul_plain(a, b)
    return matmul_cuda(a, b, **blocks)
