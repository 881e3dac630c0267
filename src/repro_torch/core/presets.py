"""Problem-size presets — the paper's §III-B sizing contribution.

SHOC ships 4 frozen sizes (too small, forever); Rodinia ships none (users
must guess). Mirovia/Altis ships *presets plus overrides*. Here every
benchmark declares presets ``0..4`` built by geometric scaling from a base
size, and ``BenchmarkSpec.build_preset(preset, **overrides)`` applies
Rodinia-style per-parameter overrides on top. Preset intents:

- 0: CI/smoke — milliseconds on one CPU core (what tests and the default
     suite run use in this container),
- 1: laptop-scale,
- 2: single accelerator,
- 3: large single accelerator (fills a v5e),
- 4: future headroom (explicitly allowed to exceed today's devices so the
     suite "stays relevant as problem sizes grow" — §III-B).
"""

from __future__ import annotations

from typing import Any, Mapping

__all__ = ["geometric_presets", "PRESET_LEVELS"]

PRESET_LEVELS = (0, 1, 2, 3, 4)


def geometric_presets(
    base: Mapping[str, Any],
    *,
    scale_keys: Mapping[str, float],
    levels: tuple[int, ...] = PRESET_LEVELS,
    round_to: int = 1,
) -> dict[int, dict[str, Any]]:
    """Build presets by scaling ``scale_keys`` of ``base`` geometrically.

    ``scale_keys`` maps parameter name -> per-level multiplier (applied
    ``level`` times). Non-scaled keys are copied verbatim. Integer parameters
    are rounded to a multiple of ``round_to`` (e.g. 8 or 128 for
    MXU-alignment-sensitive sizes).
    """
    out: dict[int, dict[str, Any]] = {}
    for level in levels:
        kwargs = dict(base)
        for key, factor in scale_keys.items():
            v = base[key]
            scaled = v * (factor**level)
            if isinstance(v, int):
                scaled = max(round_to, int(round(scaled / round_to)) * round_to)
            kwargs[key] = scaled
        out[level] = kwargs
    return out
