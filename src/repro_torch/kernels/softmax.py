"""Row-softmax kernels (the DNN Softmax benchmark, paper eq. 2).

Counterpart of ``repro/kernels/softmax.py``. The kernels are CUDA C++ for
Hopper in ``csrc/softmax.cu`` (see the note at its top for their bound and
design), one C entry point each per dtype:

- ``softmax_f32`` / ``softmax_bf16``: the row lives in registers, one block
  per row, 16-byte loads and stores, an exact row max and then one
  exponential per element. It takes rows whose width is a multiple of 16
  bytes and at most :data:`MAX_COLS`, with a base and row stride that are
  multiples of 16 bytes (:func:`_route`).
- ``softmax_f32_online`` / ``softmax_bf16_online``: one block per row, an
  online max and sum in f32, then a second pass; every other row.

- :func:`_route` names the entry a tensor goes to, from dtype, shape,
  strides and address alone (it runs on CPU tensors too); it raises on
  what no entry takes: another dtype, no axis, a last axis whose stride is
  not 1, or a layout that cannot be viewed as rows (it never copies to make
  one).
- :func:`softmax_cuda` launches that entry on a CUDA tensor of any rank,
  flattened to (R, C) rows.
- :func:`softmax_kernel` is the kernel route: CUDA tensors launch, CPU
  tensors run the plain version (:func:`softmax_plain`, the ``ref.py``
  oracle).
- :func:`softmax_model` is the register kernel's arithmetic in plain
  PyTorch, which the CPU tests hold against the reference.
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
    "softmax_model",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {
    "softmax_f32": 0, "softmax_bf16": 0, "softmax_f32_online": 0, "softmax_bf16_online": 0,
}
plain_calls = 0

MAX_COLS = 32768  # the register kernel: 1024 threads x 32 floats
_DTYPES = {torch.float32: "softmax_f32", torch.bfloat16: "softmax_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """No block parameters: the reference tiles rows and column chunks to
    fit VMEM, while here one block owns one row (single entry)."""
    return ({},)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(
            f"softmax kernel takes float32 or bfloat16, got {x.dtype}"
        )
    if x.dim() < 1:
        raise ValueError("softmax kernel needs at least one axis")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as (R, C) rows with a unit column stride; raises where
    it cannot be (it never copies to make one)."""
    c = x.shape[-1]
    if x.stride(-1) != 1 and c > 1:
        raise ValueError(
            f"softmax kernel needs a unit stride on the last axis, got {x.stride()}"
        )
    try:
        return x.view(-1, c)
    except RuntimeError:
        raise ValueError(
            f"softmax kernel cannot view shape {tuple(x.shape)} with strides "
            f"{x.stride()} as rows"
        ) from None


def _route(x: torch.Tensor) -> str:
    """The C entry point ``x`` goes to: ``softmax_f32`` / ``softmax_bf16``
    (registers) for rows of C <= :data:`MAX_COLS` values that fill whole
    16-byte vectors, on a base and (for more than one row) a row stride that
    are multiples of 16 bytes; ``softmax_f32_online`` /
    ``softmax_bf16_online`` for every other row. An empty tensor routes to
    the register entry, and nothing launches. Raises ``ValueError`` on what
    no entry takes. Looks only at dtype, shapes, strides and addresses, so
    it answers for CPU tensors too."""
    _check(x)
    if x.numel() == 0:
        return _DTYPES[x.dtype]
    x2 = _rows(x)
    r, c = x2.shape
    per16 = 16 // x.element_size()
    fits = (c % per16 == 0 and c <= MAX_COLS and x.data_ptr() % 16 == 0
            and (r == 1 or x2.stride(0) % per16 == 0))
    return _DTYPES[x.dtype] + ("" if fits else "_online")


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the entry :func:`_route` names: softmax over the last axis of
    ``x``. The route is checked before the device, so a CPU tensor reports
    a layout no entry takes first."""
    name = _route(x)
    if not x.is_cuda:
        raise ValueError(f"softmax_cuda needs a CUDA tensor, got {x.device}")
    return _launch(name, x)


# The entry that takes any row of a dtype: what a comparison times on rows
# the register kernel takes.
_ANY_LAYOUT = {torch.float32: "softmax_f32_online", torch.bfloat16: "softmax_bf16_online"}


def _launch(name: str, x: torch.Tensor) -> torch.Tensor:
    """Launch entry ``name``, one that takes ``x``: the routed one, or the
    online kernel of its dtype, which takes any row."""
    if not x.is_cuda:
        raise ValueError(f"softmax_cuda needs a CUDA tensor, got {x.device}")
    routed = _route(x)
    if name not in (routed, _ANY_LAYOUT[x.dtype]):
        raise ValueError(f"softmax entry {name} does not take this tensor ({routed} does)")
    if x.numel() == 0:
        return torch.empty_like(x)
    x2 = _rows(x)
    r, c = x2.shape
    y = torch.empty((r, c), dtype=x.dtype, device=x.device)
    fn = _build.function(name, _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x2.data_ptr(), y.data_ptr(), r, c, x2.stride(0), y.stride(0), stream)
    _build.check(status, name)
    _build.count(launches, name)
    return y.view(x.shape)


def softmax_model(x: torch.Tensor) -> torch.Tensor:
    """The register kernel's arithmetic, in plain PyTorch: the exact row max
    (from the reference's -1e30), one ``exp(x - m)`` per element, their sum
    ``l``, and ``e * (1 / max(l, 1e-30))`` in the input's dtype. It differs
    from the kernel only in the order of the sum."""
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    e = torch.exp(xf - m)
    inv = 1.0 / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (e * inv).to(x.dtype)


def softmax_kernel(x: torch.Tensor) -> torch.Tensor:
    """The kernel route: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor (the only case it runs)."""
    global plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return softmax_plain(x)
    return softmax_cuda(x)
