"""Managed (unified) memory as torch tensors: the Unified Memory study's
allocations.

PyTorch has no managed allocator, so ``csrc/managed.cu`` exposes
``cudaMallocManaged``, ``cudaMemAdvise``, ``cudaMemPrefetchAsync`` and
``cudaFree`` as C entry points, bound with ctypes like the kernels.

- :class:`ManagedBuffer` owns one allocation and frees it when it goes (or
  at :meth:`ManagedBuffer.close`). :meth:`ManagedBuffer.tensor` views it as
  a CUDA tensor through ``__cuda_array_interface__``; torch keeps the owner
  alive for as long as the tensor lives. :meth:`ManagedBuffer.from_host`
  copies a host array in from the host, so the pages start on the host and
  migrate to the card on its first touch (demand paging).
- :meth:`ManagedBuffer.prefetch` enqueues ``cudaMemPrefetchAsync`` to a card
  or, with :data:`HOST`, back to the host; :meth:`ManagedBuffer.advise`
  gives ``cudaMemAdvise`` one of :data:`ADVICE`.
- :func:`concurrent_managed_access` reads the card's
  ``cudaDevAttrConcurrentManagedAccess``. Where it is 0 the host and the card
  cannot touch managed memory at once, pages move in bulk at each launch
  rather than on demand, and a prefetch to a card fails (and raises).

A failing CUDA call raises (``_build.check``); nothing falls back to device
memory.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["ADVICE", "HOST", "ManagedBuffer", "concurrent_managed_access"]

HOST = -1  # cudaCpuDeviceId
# cudaMemoryAdvise values (the runtime's ABI) of the advice the port gives.
ADVICE = {"preferred_location": 3}

_TYPESTR = {torch.int32: "<i4", torch.int64: "<i8", torch.float32: "<f4", torch.uint8: "|u1"}
_NUMPY = {torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
          torch.uint8: np.uint8}
_FROM_NUMPY = {np.dtype(v): k for k, v in _NUMPY.items()}


def _index(device: torch.device | str | int | None) -> int:
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"managed memory lives on a CUDA device, got {device}")
    return torch.cuda.current_device() if device.index is None else device.index


def concurrent_managed_access(device: torch.device | str | int | None = None) -> int:
    """The card's ``cudaDevAttrConcurrentManagedAccess`` (1 on an H100 under
    Linux: the host and the card share managed pages, faulting them over)."""
    out = ctypes.c_int(0)
    fn = _build.function("managed_concurrent_access", [ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(_index(device), ctypes.byref(out)), "managed_concurrent_access")
    return out.value


class ManagedBuffer:
    """One ``cudaMallocManaged`` allocation of ``shape`` x ``dtype``."""

    def __init__(self, shape: tuple[int, ...], dtype: torch.dtype,
                 device: torch.device | str | int | None = None) -> None:
        if dtype not in _TYPESTR:
            raise ValueError(f"managed buffers take {sorted(map(str, _TYPESTR))}, got {dtype}")
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.device = _index(device)
        self.nbytes = math.prod(self.shape) * torch.empty((), dtype=dtype).element_size()
        ptr = ctypes.c_void_p()
        fn = _build.function("managed_alloc", [ctypes.c_void_p, ctypes.c_size_t])
        with torch.cuda.device(self.device):
            _build.check(fn(ctypes.byref(ptr), max(self.nbytes, 1)), "managed_alloc")
        self.ptr: int | None = ptr.value

    @classmethod
    def from_host(cls, array: np.ndarray,
                  device: torch.device | str | int | None = None) -> ManagedBuffer:
        """A managed copy of ``array``, written from the host: its pages are
        on the host until the card touches them."""
        array = np.ascontiguousarray(array)
        if array.dtype not in _FROM_NUMPY:
            raise ValueError(f"no managed dtype for {array.dtype}")
        buf = cls(array.shape, _FROM_NUMPY[array.dtype], device)
        buf.host_view()[...] = array
        return buf

    @property
    def __cuda_array_interface__(self) -> dict:
        if self.ptr is None:
            raise ValueError("the managed buffer was freed")
        return {"shape": self.shape, "typestr": _TYPESTR[self.dtype],
                "data": (self.ptr, False), "version": 2}

    def tensor(self) -> torch.Tensor:
        """The allocation as a CUDA tensor; it keeps this buffer alive."""
        return torch.as_tensor(self, device=f"cuda:{self.device}")

    def host_view(self) -> np.ndarray:
        """The allocation as a numpy array read and written by the host (the
        card must not be using it meanwhile)."""
        if self.ptr is None:
            raise ValueError("the managed buffer was freed")
        raw = (ctypes.c_byte * max(self.nbytes, 1)).from_address(self.ptr)
        flat = np.ctypeslib.as_array(raw)[: self.nbytes]
        return flat.view(_NUMPY[self.dtype]).reshape(self.shape)

    def advise(self, advice: str, device: int) -> None:
        """``cudaMemAdvise`` with ``ADVICE[advice]`` for ``device`` (or HOST)."""
        fn = _build.function("managed_advise",
                             [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int])
        _build.check(fn(self.ptr, self.nbytes, ADVICE[advice], device), "managed_advise")

    def prefetch(self, device: int, stream: torch.cuda.Stream | None = None) -> None:
        """Enqueue ``cudaMemPrefetchAsync`` of every page to ``device`` (or
        HOST) on ``stream`` (the current stream by default)."""
        if stream is None:
            stream = torch.cuda.current_stream(self.device)
        fn = _build.function("managed_prefetch",
                             [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
        if self.nbytes:
            _build.check(fn(self.ptr, self.nbytes, device, stream.cuda_stream),
                         "managed_prefetch")

    def close(self) -> None:
        """Free the allocation (``cudaFree`` waits for the card first)."""
        if self.ptr is not None:
            ptr, self.ptr = self.ptr, None
            fn = _build.function("managed_free", [ctypes.c_void_p])
            _build.check(fn(ptr), "managed_free")

    def __del__(self) -> None:
        if getattr(self, "ptr", None) is not None:
            self.close()
