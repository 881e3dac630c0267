"""Execution plans — the declarative half of the staged engine.

Counterpart of ``repro/core/plan.py``. An :class:`ExecutionPlan` is a frozen
value object describing *what* to run (selection by level / name / tag /
domain, or an explicit spec list), *at what size* (SHOC-style preset plus
Rodinia-style per-benchmark overrides), *which passes* (forward, and
backward where a workload defines one), *how to measure* (iters / warmup /
seed, plus ``timing_window``: sync-mode timing always runs, and a window
K > 1 additionally times K back-to-back calls per measurement), *which
implementation* (``impl``: the torch path or the hand-written kernels,
whose tiles ``tune`` sweeps), *where* (``device``: ``cuda`` unless the caller asks for ``cpu``, and a
:class:`Placement`), and *under what load* (an optional :class:`ServeSpec`:
open- or closed-loop serving through N dispatch lanes issued by a
single-threaded or thread-per-lane client, with an optional SLO, a
co-located partner, or a mix of request shapes served by the continuous
batcher; realized by the engine's serve stage through ``repro_torch.serve``).

The port runs on one device so far: a plan's placement must be one device,
``replicate``. The engine refuses more than one device, and shard placement
(device sweeps included), with :class:`PlanError` (ROADMAP queue 1, item 12).
Distributed load generation (``ServeSpec.client_procs``: N client processes
on that one device) runs.

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
    "ServeSpec",
    "ShapeBucket",
    "PlanError",
    "PLACEMENT_MODES",
    "SERVE_MODES",
    "SERVE_CLIENTS",
    "SERVE_DISPATCH",
    "IMPLS",
    "DEVICES",
]

PLACEMENT_MODES = ("replicate", "shard")
IMPLS = ("torch", "kernel")
DEVICES = ("cuda", "cpu")
SERVE_MODES = ("open", "closed")
SERVE_CLIENTS = ("single", "threaded")
# How requests map onto device work. "lanes" is the classic path (N
# dispatch lanes over the measure stage's callable); the other three are
# the mixed-shape paths of serve/batcher.py: "loop" synchronizes after
# every request, "batched" is a fixed-width torch.vmap call that waits to
# fill, "dynamic" the continuous batcher that coalesces compatible requests
# into the largest width that fits under the latency budget.
SERVE_DISPATCH = ("lanes", "loop", "batched", "dynamic")


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


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """One request shape in a serve mix: a preset (plus optional per-param
    overrides on top of it) drawn with probability proportional to
    ``weight``. Buckets are identified everywhere — requests, traces,
    callable-cache keys, per-bucket record columns — by :attr:`label`
    (``p<preset>`` plus ``/param=value`` for each override)."""

    preset: int = 0
    weight: float = 1.0
    overrides: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if self.preset < 0:
            raise PlanError(f"mix bucket preset must be >= 0, got {self.preset}")
        if not self.weight > 0:
            raise PlanError(f"mix bucket weight must be > 0, got {self.weight}")
        # JSON round-trips give lists of lists: normalize to tuples.
        object.__setattr__(
            self, "overrides", tuple(tuple(kv) for kv in self.overrides)
        )
        for kv in self.overrides:
            if len(kv) != 2 or not isinstance(kv[0], str):
                raise PlanError(
                    f"mix bucket overrides must be (param, value) pairs, "
                    f"got {self.overrides!r}"
                )
            _freeze_value("mix", kv[0], kv[1])

    @property
    def label(self) -> str:
        parts = [f"p{self.preset}"]
        parts += [f"{k}={v}" for k, v in sorted(self.overrides)]
        return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """How to serve the selected workloads under load (``repro_torch.serve``).

    - ``mode="closed"``: keep ``concurrency`` requests in flight across
      ``lanes`` dispatch lanes for ``duration_s`` seconds.
    - ``mode="open"``: Poisson arrivals at ``qps`` for ``duration_s``
      seconds, deterministic for the plan's seed; ``concurrency`` caps the
      work in flight under overload.
    - ``client``: the host's issue architecture. ``single`` dispatches
      every lane from one thread; ``threaded`` gives each lane its own
      issuing thread fed from a deterministic per-lane sub-schedule, all of
      them enqueueing on the device's current stream
      (``repro_torch.serve.client``).
    - ``slo_us``: an optional latency SLO; rows then carry ``goodput_qps``
      (completions with latency <= the SLO, per second).
    - ``colocate``: serve every selected workload paired with this
      registered benchmark on split lanes and record each tenant's slowdown
      against its isolated baseline. Closed loop and the single client
      only (the tenants alternate submissions).
    - ``mix``: a tuple of :class:`ShapeBucket`; each open-loop request
      draws its shape from this weighted distribution. The engine then
      builds one callable per (bucket, batch width) and serves through
      ``repro_torch.serve.batcher``.
    - ``dispatch``: one of :data:`SERVE_DISPATCH`.
    - ``trace``: a replayable JSONL arrival and shape trace: loaded verbatim
      when the file exists, else the generated schedule is saved there.
    - ``batch_budget_us`` / ``max_batch``: the dynamic batcher's knobs (how
      long the oldest queued request may wait, and the widest batch;
      widths are powers of two up to it).
    - ``client_procs``: distributed load generation (``repro_torch.dist``).
      0 (default) generates all load in this process; N > 0 spawns N
      client processes on the plan's device, each replaying its seeded
      share of one open-loop stream (``SeedSequence.spawn`` off the plan's
      seed: the merged stream is still Poisson at ``qps``) from one thread
      across ``lanes`` lanes and streaming its completion stamps back over
      a local socket. Open loop only.

    The checks are the reference's, case for case; a spec that is not
    mixed serves the measure stage's callable as it is.
    """

    mode: str = "closed"
    qps: float = 0.0
    concurrency: int = 4
    lanes: int = 2
    duration_s: float = 2.0
    colocate: str | None = None
    client: str = "single"
    slo_us: float | None = None
    dispatch: str = "lanes"
    mix: tuple[ShapeBucket, ...] | None = None
    trace: str | None = None
    batch_budget_us: float = 2000.0
    max_batch: int = 8
    client_procs: int = 0

    def __post_init__(self) -> None:
        if self.mix is not None:
            entries = []
            for entry in self.mix:
                if isinstance(entry, Mapping):  # RunMetadata JSON round-trip
                    known = {f.name for f in dataclasses.fields(ShapeBucket)}
                    entry = ShapeBucket(**{k: v for k, v in entry.items() if k in known})
                elif not isinstance(entry, ShapeBucket):
                    raise PlanError(f"serve mix entries must be ShapeBucket, got {entry!r}")
                entries.append(entry)
            if not entries:
                raise PlanError("serve mix must have at least one bucket")
            labels = [e.label for e in entries]
            if len(set(labels)) != len(labels):
                raise PlanError(f"serve mix has duplicate buckets: {labels}")
            object.__setattr__(self, "mix", tuple(entries))
        if self.mode not in SERVE_MODES:
            raise PlanError(f"serve mode must be one of {SERVE_MODES}, got {self.mode!r}")
        if self.client not in SERVE_CLIENTS:
            raise PlanError(
                f"serve client must be one of {SERVE_CLIENTS}, got {self.client!r}"
            )
        if self.mode == "open" and self.qps <= 0:
            raise PlanError(f"open-loop serving needs qps > 0, got {self.qps}")
        if self.concurrency < 1:
            raise PlanError(f"serve concurrency must be >= 1, got {self.concurrency}")
        if self.lanes < 1:
            raise PlanError(f"serve lanes must be >= 1, got {self.lanes}")
        if self.duration_s <= 0:
            raise PlanError(f"serve duration_s must be > 0, got {self.duration_s}")
        if self.slo_us is not None and self.slo_us <= 0:
            raise PlanError(f"serve slo_us must be > 0, got {self.slo_us}")
        if self.colocate is not None and self.mode != "closed":
            raise PlanError(
                "co-location is a closed-loop measurement; "
                f"got colocate={self.colocate!r} with mode={self.mode!r}"
            )
        if self.colocate is not None and self.client != "single":
            raise PlanError(
                "co-location dispatch is single-threaded (tenants alternate "
                f"submissions); got colocate={self.colocate!r} with "
                f"client={self.client!r}"
            )
        if self.dispatch not in SERVE_DISPATCH:
            raise PlanError(
                f"serve dispatch must be one of {SERVE_DISPATCH}, got {self.dispatch!r}"
            )
        if self.batch_budget_us <= 0:
            raise PlanError(f"batch_budget_us must be > 0, got {self.batch_budget_us}")
        if self.max_batch < 1:
            raise PlanError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.is_mixed and self.mode != "open":
            raise PlanError(
                "mixed-shape serving (mix/trace/dispatch != 'lanes') is "
                f"arrival-driven; it requires mode='open', got {self.mode!r}"
            )
        if self.is_mixed and self.client != "single":
            raise PlanError(
                "mixed-shape serving dispatches from one host thread; "
                f"it requires client='single', got {self.client!r}"
            )
        if self.is_mixed and self.colocate is not None:
            raise PlanError(
                "mixed-shape serving cannot be combined with colocate "
                f"(got colocate={self.colocate!r})"
            )
        if self.client_procs < 0:
            raise PlanError(f"client_procs must be >= 0, got {self.client_procs}")
        if self.client_procs > 0:
            if self.mode != "open":
                raise PlanError(
                    "distributed client processes replay seeded arrival "
                    "sub-schedules; client_procs requires mode='open', "
                    f"got {self.mode!r}"
                )
            if self.is_mixed:
                raise PlanError(
                    "distributed serving covers the classic lanes path; "
                    "client_procs cannot be combined with mix/trace/"
                    f"dispatch != 'lanes' (got dispatch={self.dispatch!r})"
                )
            if self.colocate is not None:
                raise PlanError(
                    "co-location is a closed-loop single-process "
                    f"measurement; got colocate={self.colocate!r} with "
                    f"client_procs={self.client_procs}"
                )
            if self.client != "single":
                raise PlanError(
                    "each distributed client process dispatches its "
                    "sub-schedule from one thread; client_procs requires "
                    f"client='single', got {self.client!r}"
                )

    @property
    def is_mixed(self) -> bool:
        """True when serving goes through the mixed-shape batcher path
        (per-bucket callables) rather than the classic lanes path."""
        return self.mix is not None or self.trace is not None or self.dispatch != "lanes"

    def buckets(self, default_preset: int) -> tuple[ShapeBucket, ...]:
        """The effective bucket set: the mix, or one bucket at the plan's
        preset when only trace/dispatch selected the mixed path."""
        if self.mix is not None:
            return self.mix
        return (ShapeBucket(preset=default_preset),)


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
    # Serve the selection under generated load after measuring it (a
    # ServeSpec), or None for isolation-only runs.
    serve: ServeSpec | None = None
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
        if self.serve is not None and not isinstance(self.serve, ServeSpec):
            raise PlanError(f"serve must be a ServeSpec, got {self.serve!r}")
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
