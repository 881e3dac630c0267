"""Structured tracing & metrics for the engine and serving stack.

The port's copy of ``repro/obs``. Dependency-free (stdlib only, no
``repro_torch`` imports) so every layer —
engine stages, the disk cache, serve lanes, the batcher — can reach the
ambient tracer without import cycles. See ``obs/tracer.py`` for the
model: spans + retrospective events + a counters registry, exported as
Chrome trace-event JSON (Perfetto / chrome://tracing) and as the
``stage_timings_us`` / ``counters`` blocks stamped into records and run
metadata (schema v8).
"""

from repro_torch.obs.tracer import (
    NULL_TRACER,
    Counters,
    NullTracer,
    SpanEvent,
    Tracer,
    current_tracer,
    set_tracer,
    use_tracer,
)

__all__ = [
    "NULL_TRACER",
    "Counters",
    "NullTracer",
    "SpanEvent",
    "Tracer",
    "current_tracer",
    "set_tracer",
    "use_tracer",
]
