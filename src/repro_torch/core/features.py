"""The CUDA features the paper studies (§V-B), as reusable helpers for the
feature studies (``repro_torch/benchmarks/feat_*.py``) and the dispatch
lanes (``serve/lanes.py``).

Counterpart of ``repro/core/features.py``, which imitates each feature on a
TPU. Here each one is the real feature on the card, under the reference's
names and contracts:

- HyperQ → :func:`concurrent_instances`, n instances as one call over
  stacked inputs (``torch.vmap``, the reference's ``jax.vmap``: occupancy),
  and :func:`async_launch`, each call on its own CUDA stream from a pool of
  :data:`STREAMS` (the hardware's work queues fed from separate streams),
  joined into the caller's current stream before it returns.
- Unified Memory → :class:`DemandStager` (a managed allocation whose pages
  move to the card when a kernel first touches them: demand paging) and
  :class:`Prefetcher` (a managed allocation advised to live on the card and
  moved there by ``cudaMemPrefetchAsync`` on a side stream), both over
  ``kernels/managed.py``.
- Dynamic Parallelism → :func:`adaptive_refine`, the reference's
  coarse/fine combinator; the device-side launch itself is the Mandelbrot
  kernel's (``kernels/mandelbrot.py``).
- Cooperative Groups → the SRAD kernel's cooperative fused step
  (``kernels/srad_stencil.py``, ``ops.srad_step(..., fused=True)``).

On the CPU, which a caller asks for by passing CPU tensors or
``device="cpu"``, the calls run in order and the stagers return plain CPU
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.kernels import managed

__all__ = [
    "STREAMS",
    "concurrent_instances",
    "async_launch",
    "cuda_tensors",
    "DemandStager",
    "Prefetcher",
    "adaptive_refine",
]

STREAMS = 32  # the side streams async_launch cycles through, per device: HyperQ's 32 queues

_POOLS: dict[int, list[torch.cuda.Stream]] = {}


def cuda_tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The CUDA tensors among the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            yield tree
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from cuda_tensors(leaf)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from cuda_tensors(leaf)


def concurrent_instances(fn: Callable[..., Any], n: int) -> Callable[..., Any]:
    """HyperQ's occupancy half: one call that runs ``n`` independent
    instances of ``fn`` over inputs stacked on a leading axis of ``n``.

    ``torch.vmap`` batches each operation of ``fn`` over the instances, so
    the card sees n instances' work in each launch. ``fn`` runs eagerly
    under it: a captured CUDA graph cannot be vmapped (its replay reads
    fixed addresses), but a graph of the batched call can be captured.
    """
    batched = torch.vmap(fn)

    def run(*stacked: torch.Tensor) -> Any:
        for x in stacked:
            if x.shape[:1] != (n,):
                raise ValueError(f"concurrent_instances({n}): input of shape "
                                 f"{tuple(x.shape)} is not stacked on a leading axis of {n}")
        return batched(*stacked)

    return run


def _pool(device: torch.device) -> list[torch.cuda.Stream]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _POOLS:
        _POOLS[index] = [torch.cuda.Stream(device=index) for _ in range(STREAMS)]
    return _POOLS[index]


def async_launch(fn: Callable[..., Any], args_list: Sequence[tuple]) -> list[Any]:
    """HyperQ's stream half: ``fn(*args)`` for each ``args``, call i on side
    stream i (mod :data:`STREAMS`), with no synchronization between them.

    Each side stream first waits for the caller's current stream (so the
    inputs are ready); before returning, the current stream waits for every
    side stream, so whatever the caller enqueues next, an event pair on the
    current stream included, comes after all the calls. Outputs are marked
    as used on the current stream for the caching allocator. On CPU inputs
    the calls run in order.
    """
    devices = {t.device for args in args_list for t in cuda_tensors(args)}
    if not devices:
        return [fn(*args) for args in args_list]
    if len(devices) > 1:
        raise ValueError("async_launch takes the inputs of one device, got "
                         f"{sorted(map(str, devices))}")
    (device,) = devices
    current = torch.cuda.current_stream(device)
    pool = _pool(device)
    used = pool[: min(len(args_list), len(pool))]
    outs = []
    for i, args in enumerate(args_list):
        stream = pool[i % len(pool)]
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            outs.append(fn(*args))
    for stream in used:
        current.wait_stream(stream)
    for t in cuda_tensors(outs):
        t.record_stream(current)
    return outs


def _host_tensor(array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array))


@dataclasses.dataclass
class DemandStager:
    """Unified Memory without prefetch: each host array, on its first
    :meth:`get`, is copied into a managed allocation from the host, so its
    pages stay on the host until a kernel touches them and the card faults
    them over (demand paging). Later gets of the same array return the same
    tensor. :meth:`evict` moves every page back to the host, so the next
    touch pays the faults again (the Unified Memory study does so before each
    timed call). On the CPU, plain CPU tensors."""

    device: str | torch.device = "cuda"
    # id(host array) -> (the array, kept so its id stays unique; its buffer; tensor)
    _cache: dict[int, tuple[np.ndarray, Any, torch.Tensor]] = dataclasses.field(
        default_factory=dict)

    def get(self, host_array: np.ndarray) -> torch.Tensor:
        key = id(host_array)
        if key not in self._cache:
            if torch.device(self.device).type == "cpu":
                self._cache[key] = (host_array, None, _host_tensor(host_array))
            else:
                buf = managed.ManagedBuffer.from_host(host_array, self.device)
                self._cache[key] = (host_array, buf, buf.tensor())
        return self._cache[key][2]

    def evict(self) -> None:
        """Every staged page back to the host, finished before returning."""
        _evict([buf for _, buf, _ in self._cache.values()])


def _evict(bufs: list) -> None:
    bufs = [b for b in bufs if b is not None]
    if not bufs:
        return
    for buf in bufs:
        buf.prefetch(managed.HOST)
    torch.cuda.synchronize(bufs[0].device)


class Prefetcher:
    """Unified Memory with advice and prefetch (``cudaMemPrefetchAsync``).

    :meth:`prefetch` stages ``host_array`` (an array or a tuple of arrays)
    under ``key``: the first time for those arrays it copies them into
    managed allocations from the host and advises the card as their
    preferred location; every time, it enqueues the pages' prefetch to the
    card on the prefetcher's side stream and records an event there. So the
    transfer overlaps whatever the current stream runs meanwhile.
    :meth:`get` makes the current stream wait for that event and returns
    the tensors, in the shape they were given. The arrays are copied once
    per (key, array objects): a host array changed in place is not staged
    again. :meth:`evict` moves every page back to the host.

    A card that reports ``concurrentManagedAccess`` 0 cannot prefetch managed
    memory to itself: the prefetch raises there, as any failed CUDA call.

    On the CPU, ``get`` returns plain CPU tensors.
    """

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self._staged: dict[Any, tuple[tuple, list, list[torch.Tensor]]] = {}
        self._pending: dict[Any, tuple[Any, torch.cuda.Event | None]] = {}
        self._stream: torch.cuda.Stream | None = None

    def prefetch(self, key: Any, host_array: Any) -> None:
        single = not isinstance(host_array, (tuple, list))
        arrays = (host_array,) if single else tuple(host_array)
        if self.device.type == "cpu":
            tensors = [_host_tensor(a) for a in arrays]
            self._pending[key] = (tensors[0] if single else tuple(tensors), None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        staged = self._staged.get(key)
        if staged is None or len(staged[0]) != len(arrays) or any(
                a is not b for a, b in zip(staged[0], arrays)):
            bufs = [managed.ManagedBuffer.from_host(a, self.device) for a in arrays]
            for buf in bufs:
                buf.advise("preferred_location", buf.device)
            staged = (arrays, bufs, [buf.tensor() for buf in bufs])
            self._staged[key] = staged
        for buf in staged[1]:
            buf.prefetch(buf.device, self._stream)
        event = torch.cuda.Event()
        event.record(self._stream)
        tensors = staged[2]
        self._pending[key] = (tensors[0] if single else tuple(tensors), event)

    def get(self, key: Any) -> Any:
        tensors, event = self._pending.pop(key)
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return tensors

    def evict(self) -> None:
        """Every staged page back to the host, finished before returning."""
        _evict([buf for _, bufs, _ in self._staged.values() for buf in bufs])


def adaptive_refine(
    coarse_fn: Callable[[torch.Tensor], torch.Tensor],
    fine_fn: Callable[[torch.Tensor], torch.Tensor],
    needs_refine: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The Mariani-Silver structure as a combinator: ``coarse_fn(x)`` is a
    cheap approximation, ``needs_refine(coarse)`` marks the elements that
    need the exact ``fine_fn(x)``. ``fine_fn`` must be total: the mask
    selects, it does not guard evaluation (``torch.where``)."""

    def run(x: torch.Tensor) -> torch.Tensor:
        coarse = coarse_fn(x)
        mask = needs_refine(coarse)
        return torch.where(mask, fine_fn(x), coarse)

    return run
