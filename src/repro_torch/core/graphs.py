"""Replay a loop of launches as one captured CUDA graph.

The reference compiles a loop such as SRAD's steps into one program
(``jax.jit`` over ``lax.fori_loop``); run eagerly here, the same loop pays
Python and a launch per kernel on every step. :class:`GraphCache` is the
counterpart of that ``jit``: it captures the loop once into a
``torch.cuda.CUDAGraph`` and replays it on later calls.

- A call names its key: whatever decides what the loop launches and where
  it reads (the input's address, shape, strides, dtype and device, the
  loop's own parameters, the route the kernel layer takes).
- The first call for a key runs the loop eagerly (which builds the kernels
  and fills the C side's cached queries, so nothing of that runs inside a
  capture) and then captures it. It returns the eager result.
- Each later call replays the graph and returns the graph's static output:
  the same tensor every time, overwritten by the next replay of that key.
- Launch counters stay equal to the launches that ran. What the wrappers
  count while the graph is captured (nothing runs then) is taken back out,
  and each replay adds it again, per counter.
- A capture or replay that fails raises; nothing falls back to the eager
  loop.
- At most ``capacity`` graphs are kept, least recently used first out,
  since each holds its own memory pool of intermediates.

:meth:`GraphCache.run` is the common case, a static loop over tensors:
keyed on the function, each tensor's address and layout and every other
argument's value, replayed on the card and called plainly on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
from collections.abc import Callable, Hashable, Sequence
from typing import Any

import torch

__all__ = ["GraphCache", "args_key"]


class _CudaGraph:
    """A ``torch.cuda.CUDAGraph`` behind the two calls the cache makes."""

    def __init__(self) -> None:
        self._graph = torch.cuda.CUDAGraph()

    def capture(self):
        return torch.cuda.graph(self._graph)

    def replay(self) -> None:
        self._graph.replay()


@dataclasses.dataclass
class _Entry:
    graph: Any
    out: Any
    launched: list[tuple[dict, dict]]  # (counter, launches a replay adds to it)


class GraphCache:
    """Captured graphs by key, least recently used first out.

    ``new_graph`` makes the graph object (``capture()``, a context manager
    inside which the loop is recorded, and ``replay()``); the default is a
    ``torch.cuda.CUDAGraph``.
    """

    def __init__(self, capacity: int = 4,
                 new_graph: Callable[[], Any] = _CudaGraph) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._new_graph = new_graph
        self._entries: collections.OrderedDict[Hashable, _Entry] = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def clear(self) -> None:
        self._entries.clear()

    def __call__(self, key: Hashable, fn: Callable[..., Any], args: Sequence[Any],
                 counters: Sequence[dict]) -> Any:
        """``fn(*args)``: eagerly and then captured on the first call for
        ``key``, a replay of the capture after. ``counters`` are the launch
        counters ``fn`` may move (dicts of name -> count)."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            entry.graph.replay()
            for counter, delta in entry.launched:
                for name, n in delta.items():
                    counter[name] += n
            return entry.out
        out = fn(*args)
        self._entries[key] = self._capture(fn, args, counters)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return out

    def run(self, fn: Callable[..., Any], *args: Any) -> Any:
        """``fn(*args)``, for a loop that launches no counted kernel: on CUDA
        tensors one replay of its graph, keyed by :func:`args_key`; on CPU
        tensors a plain call."""
        if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return fn(*args)
        return self(args_key(fn, args), fn, args, ())

    def _capture(self, fn: Callable[..., Any], args: Sequence[Any],
                 counters: Sequence[dict]) -> _Entry:
        before = [dict(c) for c in counters]
        graph = self._new_graph()
        launched = []
        try:
            with graph.capture():
                out = fn(*args)
        finally:
            # Nothing ran during the capture: take its counts back out.
            for counter, was in zip(counters, before, strict=True):
                delta = {k: n - was.get(k, 0) for k, n in counter.items()
                         if n != was.get(k, 0)}
                for k, n in delta.items():
                    counter[k] -= n
                launched.append((counter, delta))
        return _Entry(graph, out, launched)


def args_key(fn: Callable[..., Any], args: Sequence[Any]) -> tuple:
    """What a captured call of ``fn`` depends on: each tensor argument's
    address, shape, strides, dtype and device, and every other argument's
    value."""
    return (fn,) + tuple(
        (a.data_ptr(), tuple(a.shape), a.stride(), a.dtype, a.device)
        if isinstance(a, torch.Tensor) else a
        for a in args
    )
