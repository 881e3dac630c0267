"""Execution plans — the declarative half of the staged engine.

Counterpart of ``repro/core/plan.py``. An :class:`ExecutionPlan` is a frozen
value object describing *what* to run (selection by level / name / tag /
domain, or an explicit spec list), *at what size* (SHOC-style preset plus
Rodinia-style per-benchmark overrides), *which passes* (forward, and
backward where a workload defines one), *how to measure* (iters / warmup /
seed, plus ``timing_window``: sync-mode timing always runs, and a window
K > 1 additionally times K back-to-back calls per measurement), *which
implementation* (``impl``: the torch path or the hand-written kernels,
whose tiles ``tune`` sweeps), and *where* (``device``: ``cuda`` unless the caller asks for ``cpu``, and a
:class:`Placement`).

The port runs on one device so far: a plan's placement must be one device,
``replicate`` (the engine refuses anything else with :class:`PlanError`).
Device sweeps and serving are not ported yet; a plan that asks to serve is
refused.

Plans carry no execution state: the engine (``core/engine.py``) consumes a
plan, owns the callable cache and the stage sequence, and emits records.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.registry import BenchmarkSpec, Workload, all_benchmarks

__all__ = [
    "ExecutionPlan",
    "Placement",
    "PlanError",
    "PLACEMENT_MODES",
    "IMPLS",
    "DEVICES",
]

PLACEMENT_MODES = ("replicate", "shard")
IMPLS = ("torch", "kernel")
DEVICES = ("cuda", "cpu")


class PlanError(ValueError):
    """A plan or placement that cannot be executed as configured (bad
    selection, unknown mode, a device this host does not have). CLIs treat
    it as a configuration error — exit 2, no traceback."""


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a plan runs: how many devices, and what lands on them
    (``replicate``: full copies; ``shard``: inputs partitioned along the
    workload's ``batch_dims``)."""

    devices: int = 1
    mode: str = "replicate"

    def __post_init__(self) -> None:
        if self.devices < 1:
            raise PlanError(f"placement devices must be >= 1, got {self.devices}")
        if self.mode not in PLACEMENT_MODES:
            raise PlanError(
                f"placement mode must be one of {PLACEMENT_MODES}, got {self.mode!r}"
            )


def _freeze_value(name: str, param: str, value: Any) -> Any:
    """Override values feed the engine's cache key: fail fast on unhashable
    ones (lists become tuples) instead of erroring per benchmark."""
    if isinstance(value, list):
        value = tuple(value)
    try:
        hash(value)
    except TypeError:
        raise ValueError(
            f"override {name}.{param}={value!r} is not hashable; "
            f"use scalars or tuples"
        ) from None
    return value


def _freeze_overrides(
    overrides: Mapping[str, Mapping[str, Any]] | None,
) -> tuple[tuple[str, tuple[tuple[str, Any], ...]], ...]:
    """Canonicalize name->{param: value} into a hashable, sorted tuple."""
    if not overrides:
        return ()
    return tuple(
        (
            name,
            tuple(
                (param, _freeze_value(name, param, value))
                for param, value in sorted(kwargs.items())
            ),
        )
        for name, kwargs in sorted(overrides.items())
    )


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """What to run, at what size, how many passes, on which device."""

    levels: tuple[int, ...] = (0, 1, 2)
    names: tuple[str, ...] | None = None
    tags: tuple[str, ...] | None = None
    domains: tuple[str, ...] | None = None
    preset: int = 0
    # Rodinia-style size overrides: benchmark name -> {param: value}, applied
    # on top of the preset by BenchmarkSpec.build_preset.
    overrides: tuple[tuple[str, tuple[tuple[str, Any], ...]], ...] = ()
    include_backward: bool = True
    iters: int = 5
    warmup: int = 2
    seed: int = 0
    # Windowed timing: per measured pass, additionally time `iters` windows
    # of K back-to-back calls with one synchronization each (K=1 disables).
    timing_window: int = 4
    # One device, replicate (the only placement the port runs so far).
    # `devices=N` is accepted as sugar for Placement(devices=N); after
    # construction `plan.devices` mirrors `plan.placement.devices`.
    placement: Placement | None = None
    devices: int | None = None
    # Implementation axis: "torch" times the plain PyTorch path; "kernel"
    # times the hand-written kernel for workloads that declare one
    # (Workload.kernel), with a recorded fallback to torch otherwise.
    impl: str = "torch"
    # Autotune: sweep each kernel's tune_space() in a stage between place and
    # compile, timing candidates with the windowed timer; the winner persists
    # in the engine's disk cache (--cache-dir) so warm runs skip the sweep.
    # No-op for impl="torch" (there is nothing to tune on the torch path).
    tune: bool = False
    # "cuda" (default) or "cpu". A CPU run of impl="kernel" runs the
    # kernels' plain versions, and its rows say so (impl_interpret=True).
    device: str = "cuda"
    # Serving is not ported yet: any value but None is refused.
    serve: Any = None
    # Escape hatch for tests and programmatic callers: bypass the registry
    # and run exactly these specs (selection filters are ignored).
    specs: tuple[BenchmarkSpec, ...] | None = None

    def __post_init__(self) -> None:
        def norm(field: str, value):
            if value is not None and not isinstance(value, tuple):
                object.__setattr__(self, field, tuple(value))

        for f in ("levels", "names", "tags", "domains", "specs"):
            norm(f, getattr(self, f))
        if not isinstance(self.overrides, tuple):
            object.__setattr__(self, "overrides", _freeze_overrides(self.overrides))
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if self.warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {self.warmup}")
        if self.timing_window < 1:
            raise ValueError(
                f"timing_window must be >= 1 (1 = sync-only), "
                f"got {self.timing_window}"
            )
        if self.impl not in IMPLS:
            raise PlanError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        if self.device not in DEVICES:
            raise PlanError(f"device must be one of {DEVICES}, got {self.device!r}")
        if self.serve is not None:
            raise PlanError("serving is not ported yet; plan.serve must be None")
        self._resolve_placement()

    def _resolve_placement(self) -> None:
        placement = self.placement
        if placement is None:
            devices = 1 if self.devices is None else self.devices
            if devices < 1:
                raise PlanError(f"devices must be >= 1, got {devices}")
            placement = Placement(devices=devices, mode="replicate")
        elif isinstance(placement, int):  # Placement-shaped sugar
            placement = Placement(devices=placement, mode="replicate")
        elif not isinstance(placement, Placement):
            raise PlanError(
                f"placement must be a Placement (or int), got {placement!r}"
            )
        if self.devices is not None and self.devices != placement.devices:
            raise PlanError(
                f"conflicting device counts: devices={self.devices} vs "
                f"placement.devices={placement.devices}; pass one or the other"
            )
        object.__setattr__(self, "placement", placement)
        object.__setattr__(self, "devices", placement.devices)

    # -- selection ---------------------------------------------------------

    def select(self) -> list[BenchmarkSpec]:
        """Resolve the plan's selection against the registry (or ``specs``)."""
        if self.specs is not None:
            if not self.specs:
                raise ValueError("plan.specs is empty")
            return list(self.specs)
        cands = all_benchmarks()
        if self.names is not None:
            known = {s.name for s in cands}
            unknown = sorted(set(self.names) - known)
            if unknown:
                raise ValueError(
                    f"unknown benchmark(s) {unknown}; known: {sorted(known)}"
                )
        selected = [
            s
            for s in cands
            if s.level in self.levels
            and (self.names is None or s.name in self.names)
            and (self.tags is None or set(self.tags) & set(s.tags))
            and (self.domains is None or s.domain in self.domains)
        ]
        if not selected:
            raise ValueError(
                f"no benchmarks match levels={self.levels} names={self.names} "
                f"tags={self.tags} domains={self.domains}"
            )
        return selected

    def resolve_preset(self, spec: BenchmarkSpec) -> int:
        """The plan preset, clamped to the smallest one the spec defines."""
        return self.preset if self.preset in spec.presets else min(spec.presets)

    def overrides_for(self, name: str) -> dict[str, Any]:
        for n, kwargs in self.overrides:
            if n == name:
                return dict(kwargs)
        return {}

    def passes(self, workload: Workload) -> list[bool]:
        """[False] (forward), plus [True] when backward is planned+defined."""
        out = [False]
        if self.include_backward and workload.fn_bwd is not None:
            out.append(True)
        return out
