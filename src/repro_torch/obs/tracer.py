"""The tracing core: spans, retrospective events, counters, Chrome export.

Model
-----

A :class:`Tracer` collects :class:`SpanEvent` rows — named intervals on a
monotonic clock (``time.perf_counter``), zeroed at tracer construction —
two ways:

- ``with tracer.span("compile", bench="gemm_f32_nn"):`` times a live code
  region on whatever thread runs it (the thread ident is recorded, so
  spans from N serving threads land on N Chrome tracks);
- ``tracer.event("request", t_start=c.t_submit, t_end=c.t_done, ...)``
  records an interval *after the fact* from perf_counter timestamps
  something else already measured — how serve completions and batcher
  executions become trace rows without instrumenting their hot loops.

Every event carries a ``track`` (a process-level grouping in the Chrome
model: ``engine``, ``serve``, ``batcher``) and an optional explicit
``tid`` (``"lane 0"``, ``"queue p0/cols=64"``) overriding the thread
ident — which is what renders serve lanes and batcher queues as separate
named tracks. A :class:`Counters` registry rides along for scalar totals
(cache hits, tune trials, batcher flushes, lane submit-block time).

Zero-cost when disabled
-----------------------

:data:`NULL_TRACER` (a :class:`NullTracer`) is falsy, has
``enabled=False``, hands out one shared no-op context manager, and its
counters swallow increments. Call sites on hot paths guard with
``if tracer.enabled:`` so the disabled cost is one attribute read; the
timing hot loop (``harness.time_fn``) is never instrumented at all, so
disabled tracing is *structurally* identical to an uninstrumented build
where it matters (asserted in ``tests/test_obs.py``).

The ambient tracer (:func:`current_tracer` / :func:`use_tracer`) lets the
serve layer reach the engine's tracer without threading a parameter
through every client/lane signature; the default is :data:`NULL_TRACER`.

Everything here is stdlib-only and imports nothing from ``repro_torch``.
It is the port's own copy of ``repro/obs/tracer.py``, unchanged but for
that name: the port imports no module of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Iterator

__all__ = [
    "SpanEvent",
    "Counters",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "current_tracer",
    "set_tracer",
    "use_tracer",
]


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One named interval: microseconds relative to the tracer's origin,
    grouped by ``track`` (Chrome process) and ``tid`` (Chrome thread —
    a real thread ident, or an explicit label like ``"lane 0"``)."""

    name: str
    t_start_us: float
    dur_us: float
    track: str
    tid: int | str
    args: dict


class Counters:
    """Thread-safe named totals. Values are numbers (ints for counts,
    floats for accumulated microseconds); ``snapshot()`` returns a plain
    sorted dict that JSON-serializes into :class:`RunMetadata`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
        """Overwrite a total (for folding in externally-accumulated
        counters like the disk cache's, which are cumulative across runs
        — incrementing them again would double-count)."""
        with self._lock:
            self._values[name] = value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._values.get(name, default)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(sorted(self._values.items()))


class _NullCounters(Counters):
    """Counters that swallow increments (the disabled path)."""

    def inc(self, name: str, value: float = 1) -> None:
        return None

    def set(self, name: str, value: float) -> None:
        return None


class Tracer:
    """Collects spans/events/counters; exports Chrome trace-event JSON."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[SpanEvent] = []
        self.counters = Counters()
        self._t0 = time.perf_counter()
        self._main_ident = threading.get_ident()

    def __bool__(self) -> bool:
        return True

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        track: str = "engine",
        tid: int | str | None = None,
        **attrs: Any,
    ) -> Iterator[None]:
        """Time a live code region; the event is recorded on exit (also on
        exception — a failing stage still shows its time in the trace)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._append(
                SpanEvent(
                    name=name,
                    t_start_us=(t0 - self._t0) * 1e6,
                    dur_us=(t1 - t0) * 1e6,
                    track=track,
                    tid=tid if tid is not None else threading.get_ident(),
                    args=attrs,
                )
            )

    def event(
        self,
        name: str,
        *,
        t_start: float,
        t_end: float,
        track: str = "engine",
        tid: int | str | None = None,
        **attrs: Any,
    ) -> None:
        """Record an interval retrospectively from ``perf_counter``
        timestamps measured elsewhere (serve completions, batch
        executions). ``dur_us`` is exactly ``(t_end - t_start) * 1e6`` —
        callers that also sum the same deltas (the tune stage) get
        sum-of-spans equality by construction."""
        self._append(
            SpanEvent(
                name=name,
                t_start_us=max(0.0, (t_start - self._t0) * 1e6),
                dur_us=(t_end - t_start) * 1e6,
                track=track,
                tid=tid if tid is not None else threading.get_ident(),
                args=attrs,
            )
        )

    def _append(self, event: SpanEvent) -> None:
        with self._lock:
            self._events.append(event)

    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    # -- export ------------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event list: one ``"X"`` (complete) event per span,
        plus ``"M"`` metadata naming each track (process) and tid (thread).

        Tracks map to pids in order of first appearance; within a track,
        tids map to small sequential numbers — explicit string tids (lane
        and queue labels) keep their label as the thread name, real thread
        idents become ``main`` / ``thread-K``. Events are sorted by
        (pid, tid, start) so the export is stable for a given event set.
        """
        events = self.events()
        pids: dict[str, int] = {}
        tids: dict[tuple[str, int | str], int] = {}
        meta: list[dict] = []
        rows: list[tuple[tuple, dict]] = []
        for ev in events:
            pid = pids.get(ev.track)
            if pid is None:
                pid = pids[ev.track] = len(pids) + 1
                meta.append(
                    {
                        "ph": "M",
                        "pid": pid,
                        "name": "process_name",
                        "args": {"name": ev.track},
                    }
                )
            key = (ev.track, ev.tid)
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = (
                    sum(1 for t, _ in tids if t == ev.track) + 1
                )
                if isinstance(ev.tid, str):
                    tname = ev.tid
                elif ev.tid == self._main_ident:
                    tname = "main"
                else:
                    tname = f"thread-{tid}"
                meta.append(
                    {
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "name": "thread_name",
                        "args": {"name": tname},
                    }
                )
            rows.append(
                (
                    (pid, tid, ev.t_start_us),
                    {
                        "ph": "X",
                        "name": ev.name,
                        "cat": ev.track,
                        "pid": pid,
                        "tid": tid,
                        "ts": round(ev.t_start_us, 3),
                        "dur": round(max(ev.dur_us, 0.0), 3),
                        "args": ev.args,
                    },
                )
            )
        rows.sort(key=lambda r: r[0])
        return meta + [row for _, row in rows]

    def export_chrome(self, path: str) -> int:
        """Write ``{"traceEvents": [...]}`` (the Chrome/Perfetto envelope)
        atomically; returns the number of span events exported."""
        events = self.chrome_events()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"},
                f,
                sort_keys=True,
            )
        os.replace(tmp, path)
        return sum(1 for e in events if e.get("ph") == "X")


class NullTracer:
    """The disabled tracer: falsy, no-op spans, counter increments
    swallowed. One shared context manager instance, so the disabled
    ``span()`` cost is a method call returning an existing object."""

    enabled = False
    counters = _NullCounters()
    _span = contextlib.nullcontext()

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **attrs: Any) -> contextlib.nullcontext:
        return self._span

    def event(self, name: str, **attrs: Any) -> None:
        return None

    def events(self) -> list[SpanEvent]:
        return []


NULL_TRACER = NullTracer()

# The ambient tracer serve modules consult (engine.run installs its own
# for the duration of a run via use_tracer). Module-global, not
# thread-local: lane worker threads are spawned *inside* a run and must
# see the run's tracer.
_CURRENT: Tracer | NullTracer = NULL_TRACER


def current_tracer() -> Tracer | NullTracer:
    return _CURRENT


def set_tracer(tracer: Tracer | NullTracer | None) -> None:
    global _CURRENT
    _CURRENT = tracer if tracer is not None else NULL_TRACER


@contextlib.contextmanager
def use_tracer(tracer: Tracer | NullTracer | None) -> Iterator[None]:
    """Install ``tracer`` as the ambient tracer for a scope (restores the
    previous one on exit, so nested engine runs compose)."""
    global _CURRENT
    prev = _CURRENT
    set_tracer(tracer)
    try:
        yield
    finally:
        _CURRENT = prev
