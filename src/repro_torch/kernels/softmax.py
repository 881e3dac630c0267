"""Row-softmax kernel (the DNN Softmax benchmark, paper eq. 2).

Counterpart of ``repro/kernels/softmax.py``. The kernel is CUDA C++ for
Hopper in ``csrc/softmax.cu`` (see the note at its top for its bound and
design): one block per row, an online max and sum in f32, then a second
pass that writes ``exp(x - m) / l`` in the input's dtype, reading the row
back from shared memory when it fits.

- :func:`softmax_cuda` launches the kernel on a CUDA tensor of any rank,
  flattened to (R, C) rows. It raises on another device or dtype, or on a
  layout that cannot be viewed as rows with a unit column stride (it never
  copies to make one).
- :func:`softmax_kernel` is the kernel route: CUDA tensors launch, CPU
  tensors run the plain version (:func:`softmax_plain`, the ``ref.py``
  oracle).
- ``launches`` (per C entry point) and ``plain_calls`` count as in
  ``kernels/matmul.py``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import softmax_ref as softmax_plain

__all__ = [
    "softmax_cuda",
    "softmax_kernel",
    "softmax_plain",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"softmax_f32": 0, "softmax_bf16": 0}
plain_calls = 0

_DTYPES = {torch.float32: "softmax_f32", torch.bfloat16: "softmax_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """No block parameters: the reference tiles rows and column chunks to
    fit VMEM, while here one block owns one row (single entry)."""
    return ({},)


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: softmax over the last axis of ``x``."""
    if not x.is_cuda:
        raise ValueError(f"softmax_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(
            f"softmax kernel takes float32 or bfloat16, got {x.dtype}"
        )
    if x.dim() < 1:
        raise ValueError("softmax kernel needs at least one axis")
    c = x.shape[-1]
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.stride(-1) != 1 and c > 1:
        raise ValueError(
            f"softmax kernel needs a unit stride on the last axis, got {x.stride()}"
        )
    try:
        x2 = x.view(-1, c)
    except RuntimeError:
        raise ValueError(
            f"softmax kernel cannot view shape {tuple(x.shape)} with strides "
            f"{x.stride()} as rows"
        ) from None
    r = x2.shape[0]
    y = torch.empty((r, c), dtype=x.dtype, device=x.device)
    name = _DTYPES[x.dtype]
    fn = _build.function(name, _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x2.data_ptr(), y.data_ptr(), r, c, x2.stride(0), y.stride(0), stream)
    _build.check(status, name)
    launches[name] += 1
    return y.view(x.shape)


def softmax_kernel(x: torch.Tensor) -> torch.Tensor:
    """The kernel route: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor (the only case it runs)."""
    global plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return softmax_plain(x)
    return softmax_cuda(x)
