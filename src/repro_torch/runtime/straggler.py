"""Straggler detection and mitigation policy (a copy of
``repro/runtime/straggler.py``; stdlib only).

In synchronous SPMD every step runs at the pace of the slowest participant;
a straggler is invisible *inside* the program and shows up as inflated
step wall-time. The monitor keeps a robust baseline (EMA of the step-time
median) and flags sustained deviation; the mitigation ladder is:

1. observe (always) — flag + log, feeds the ops dashboard,
2. checkpoint-now — cut the loss window before a suspected failure,
3. elastic re-mesh (runtime/elastic.py) — evict the slow host and resume.

Eviction is deliberately not automatic-by-default: on real pods transient
HBM ECC scrubs or host GC cause false positives, and a re-mesh costs a
checkpoint restore; ``sustained`` controls how many consecutive slow steps
arm the trigger (DESIGN.md §9).
"""

from __future__ import annotations

import dataclasses

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 1.5  # step is "slow" above threshold × baseline
    sustained: int = 5  # consecutive slow steps before triggering
    ema: float = 0.05  # baseline update rate

    _baseline: float | None = None
    _slow_run: int = 0
    triggered: int = 0

    def record(self, step_seconds: float) -> bool:
        """Record one step; returns True when mitigation should trigger."""
        if self._baseline is None:
            self._baseline = step_seconds
            return False
        slow = step_seconds > self.threshold * self._baseline
        if slow:
            self._slow_run += 1
        else:
            self._slow_run = 0
            # Only track the baseline on healthy steps — a straggler must
            # not drag the baseline up and mask itself.
            self._baseline = (1 - self.ema) * self._baseline + self.ema * step_seconds
        if self._slow_run >= self.sustained:
            self._slow_run = 0
            self.triggered += 1
            return True
        return False

    @property
    def baseline(self) -> float | None:
        return self._baseline
