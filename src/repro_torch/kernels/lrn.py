"""Cross-channel LRN kernels (the DNN LRN benchmark, paper eq. 3).

Counterpart of ``repro/kernels/lrn.py``. The kernels are CUDA C++ for Hopper
in ``csrc/lrn.cu`` (see the note at its top for their bound and design):
each output sums its own window of ``size`` squares over the channels, in
the oracle's order. The TPU kernel's band-matrix product on the MXU is not
carried over. Two C entry points:

- ``lrn_f32``: sizes 3 and 5 on an input whose S = H*W is a multiple of 4
  and whose base is 16-byte aligned. Each thread owns four neighbouring
  spatial positions (one float4) and walks a chunk of 32 channels plus the
  halo, the window's squares in a register ring.
- ``lrn_f32_smem``: every other input: any odd size up to 65, any S. A
  block stages a 32-channel chunk plus the halo in shared memory.

- :func:`_route` names the entry an input goes to, from dtype, shape,
  strides, address and ``size`` alone (it runs on CPU tensors too); it
  raises on what no entry takes: another dtype or rank, a layout that is
  not contiguous, an even ``size`` (see :func:`lrn_kernel`), a ``size``
  above 65 (the shared-memory tile's limit) and more images or channel
  chunks than the grid holds (65535 each).
- :func:`lrn_cuda` launches that entry on a CUDA tensor.
- :func:`lrn_model` is ``lrn_f32``'s arithmetic in plain PyTorch, which
  the CPU tests hold against the reference.
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
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lrn_ref as lrn_plain

__all__ = [
    "lrn_cuda",
    "lrn_kernel",
    "lrn_plain",
    "lrn_model",
    "tune_space",
    "launches",
    "plain_calls",
]

launches = {"lrn_f32": 0, "lrn_f32_smem": 0}
plain_calls = 0

RING_SIZES = (3, 5)  # the register ring's compiled windows
MAX_SIZE = 65  # lrn_f32_smem's channel tile (32 + size - 1 rows of 128) fits 48 KB
MAX_N = 65535  # lrn_f32_smem's grid z extent (images)
MAX_C = 65535 * 32  # either grid's y extent (chunks of 32 channels)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p]


def tune_space() -> tuple[dict, ...]:
    """No block parameters (single entry): the reference sweeps ``block_s``
    (spatial positions per grid step), while here a thread walks 32 output
    channels of four spatial positions (``lrn_f32``) or of one
    (``lrn_f32_smem``), which at the DNN presets' 16x16 images makes a
    thousand blocks or more."""
    return ({},)


def _check_size(size: int) -> None:
    if size < 1 or size % 2 == 0:
        raise ValueError(
            f"lrn kernel takes an odd window size, got {size}: for an even size "
            "the reference's kernel sums size+1 channels and its oracle size"
        )


def _route(x: torch.Tensor, size: int) -> str:
    """The C entry point ``x`` and ``size`` go to: ``lrn_f32`` for a size in
    :data:`RING_SIZES`, S a multiple of 4 and a 16-byte aligned base;
    ``lrn_f32_smem`` for every other input. Raises ``ValueError`` on what no
    entry takes. Looks only at dtype, shape, strides and address, so it
    answers for CPU tensors too."""
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
    ring = size in RING_SIZES and (h * w) % 4 == 0 and x.data_ptr() % 16 == 0
    return "lrn_f32" if ring else "lrn_f32_smem"


def lrn_cuda(
    x: torch.Tensor,
    *,
    size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    k: float = 2.0,
) -> torch.Tensor:
    """Launch the entry :func:`_route` names on ``x`` (N, C, H, W), float32.
    The route is checked before the device, so a CPU tensor reports a
    layout no entry takes first."""
    name = _route(x, size)
    if not x.is_cuda:
        raise ValueError(f"lrn_cuda needs a CUDA tensor, got {x.device}")
    return _launch(name, x, size=size, alpha=alpha, beta=beta, k=k)


def _launch(name: str, x: torch.Tensor, *, size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """Launch entry ``name``, one that takes ``x``: the routed one, or
    ``lrn_f32_smem``, which takes every input the route accepts."""
    if not x.is_cuda:
        raise ValueError(f"lrn_cuda needs a CUDA tensor, got {x.device}")
    routed = _route(x, size)
    if name not in (routed, "lrn_f32_smem"):
        raise ValueError(f"lrn entry {name} does not take this input ({routed} does)")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    n, c, h, w = x.shape
    fn = _build.function(name, _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), y.data_ptr(), n, c, h * w, size // 2, alpha, beta, k, stream)
    _build.check(status, name)
    _build.count(launches, name)
    return y


def lrn_model(
    x: torch.Tensor,
    *,
    size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    k: float = 2.0,
) -> torch.Tensor:
    """``lrn_f32``'s arithmetic, in plain PyTorch: the oracle's window sum
    (each square rounded, channel ``c - size//2`` first), then ``x *
    2^(-beta * log2(k + alpha * win))`` in place of the oracle's ``x / (k +
    alpha * win)^beta``."""
    xf = x.float()
    half = size // 2
    c = x.shape[1]
    padded = F.pad(xf * xf, (0, 0, 0, 0, half, half))
    win = sum(padded[:, i : i + c] for i in range(size))
    return (xf * torch.exp2(-beta * torch.log2(k + alpha * win))).to(x.dtype)


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
