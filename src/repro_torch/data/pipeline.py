"""Host-to-device prefetch pipeline: the training loop's Unified-Memory
analogue.

Counterpart of ``repro/data/pipeline.py``. A daemon thread builds batch
``step + k`` while the device runs step ``step``: it copies the batch into
pinned host memory, issues the copy to the device on a side CUDA stream and
records an event there; the consumer's stream waits on that event (a wait
on the device, not on the host), so the transfer overlaps compute as the
reference's asynchronous ``device_put`` does. A bounded queue of ``depth``
batches is the backpressure that caps host memory; ``close`` stops the
thread and drains the queue.

On the CPU the batch becomes tensors with no copy beyond ``from_numpy``. A
``sharding`` (the reference's batch placement over a mesh) is placement over
several GPUs, ROADMAP.md queue 1, item 12: it raises.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

__all__ = ["Prefetch"]


class Prefetch:
    def __init__(
        self,
        batch_at: Callable[[int], dict],
        *,
        start_step: int = 0,
        depth: int = 2,
        sharding=None,
        device: str | torch.device = "cuda",
    ):
        if sharding is not None:
            raise NotImplementedError(
                "a batch sharding places batches over several GPUs: ROADMAP.md queue 1, "
                "item 12; the port prefetches onto one device"
            )
        self._batch_at = batch_at
        self._device = torch.device(device)
        if self._device.type == "cuda" and self._device.index is None:
            # The worker thread binds a card by number.
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, batch: dict):
        """-> (tensors on the device, the event their copies complete at, or
        None on the CPU)."""
        if self._device.type != "cuda":
            return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None
        stream = self._stream
        with torch.cuda.stream(stream):
            out = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    self._device, non_blocking=True)
                for k, v in batch.items()
            }
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _put(self, item) -> None:
        # Block until the consumer drains: backpressure caps host memory.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self) -> None:
        try:
            if self._device.type == "cuda":
                # Every new host thread binds the card's context first.
                torch.cuda.set_device(self._device)
                self._stream = torch.cuda.Stream(self._device)
            step = self._step
            while not self._stop.is_set():
                self._put((step, *self._to_device(self._batch_at(step))))
                step += 1
        except Exception as e:  # the consumer raises it: a dead worker must not hang it
            self._put((None, e, None))

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            step, batch, event = self._q.get()
            if step is None:
                raise RuntimeError("the prefetch thread failed") from batch
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                for t in batch.values():
                    # Made on the side stream, used on this one: the
                    # allocator must not reuse them before this stream is done.
                    t.record_stream(current)
            yield step, batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
